"""Build and load the package's CUDA kernels.

At first use, nvcc compiles every dpgo_tpu_torch/csrc/*.cu into one shared
library with a plain C interface under build/dpgo_tpu_torch/ at the
repository root, and ctypes loads it. The library's name carries a hash of
the sources and the flags, so an edited source rebuilds. Nothing here runs
at import time: this module is imported on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdpgo_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return its
    path. Raises with nvcc's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a temporary name and rename, so a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dpgo_segsum_csr_f32.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.dpgo_segsum_csr_f32.restype = ci
        _lib = lib
    return _lib
