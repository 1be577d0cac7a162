"""Build and load the package's CUDA kernels.

At first use, nvcc compiles every dpgo_tpu_torch/csrc/*.cu to an object,
one nvcc process per source, all started together, and links them into one
shared library with a plain C interface under build/dpgo_tpu_torch/ at the
repository root, which ctypes loads. The library's name carries a hash of
the sources, the headers and the flags, so an edited source rebuilds.
ptxas's report of each kernel's registers and spills is kept beside the
library (ptxas_report). Nothing here runs at import time: this module is
imported on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "dpgo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); "
            "the CUDA kernels cannot be built"
        )
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdpgo_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmds: list) -> list:
    """Run the commands side by side; raise with nvcc's output if any fails.
    Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}{err}")
    return [err for _, err in outs]


def build() -> Path:
    """Compile the sources unless the library for them exists; return its
    path. Raises with nvcc's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory and rename, so a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        logs = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(_sources(), objs)])
        lib = Path(tmp) / so.name
        _run([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
        so.with_suffix(".ptxas.txt").write_text("".join(logs))
        os.replace(lib, so)
    return so


def ptxas_report() -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel in the built library, from ptxas -v; kernel names are mangled."""
    text = build().with_suffix(".ptxas.txt").read_text()
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1))) + spill)
            name, spill = None, (0, 0)
    return rows


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dpgo_segsum_csr_f32.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.dpgo_segsum_csr_f32.restype = ci
        lib.dpgo_edge_matvec_f32.argtypes = [vp] * 8 + [ci] * 3 + [vp]
        lib.dpgo_edge_matvec_f32.restype = ci
        _lib = lib
    return _lib
