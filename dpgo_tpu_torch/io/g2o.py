"""g2o dataset parser.

Reads EDGE_SE2 / EDGE_SE3:QUAT lines with the same precision conventions as
the reference (reference: src/DPGO_utils.cpp:113-257):

  * SE2: tau = 2 / trace(TranCov^-1) with TranCov = [[I11,I12],[I12,I22]];
    kappa = I33.
  * SE3: tau = 3 / trace(TranCov^-1); kappa = 3 / (2 trace(RotCov^-1)) —
    the information-divergence-minimizing isotropic approximations.
  * odometry edges (j == i+1) get fixed_weight = True.

Two implementations under one API:
  * a native C++ parser (csrc/g2o_parser.cpp -> libdpgo_io.so, loaded via
    ctypes) — the fast data-loader path for large files, auto-built with
    `make -C csrc` on first use;
  * a vectorized numpy fallback (one pass to split lines, then batched float
    parsing) used when the native library is unavailable or
    DPGO_TPU_NO_NATIVE=1.

Host IO only: a numpy copy of dpgo_tpu/io/g2o.py that loads the same native
library from the repository's csrc/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from dpgo_tpu_torch.measurements import EdgeArrays, RelativeSEMeasurement

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
)
_native_lib: Optional[ctypes.CDLL] = None
_native_failed = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native parser; None if unavailable."""
    global _native_lib, _native_failed
    if _native_lib is not None:
        return _native_lib
    if _native_failed or os.environ.get("DPGO_TPU_NO_NATIVE") == "1":
        return None
    so_path = os.path.join(_NATIVE_DIR, "libdpgo_io.so")
    try:
        if not os.path.exists(so_path):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(so_path)
        lib.dpgo_g2o_count.restype = ctypes.c_long
        lib.dpgo_g2o_count.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dpgo_g2o_parse.restype = ctypes.c_long
        lib.dpgo_g2o_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        _native_lib = lib
        return lib
    except Exception:
        _native_failed = True
        return None


def _read_g2o_native(filename: str) -> Optional[Tuple[EdgeArrays, int]]:
    lib = _load_native()
    if lib is None:
        return None
    dim = ctypes.c_int(0)
    m = lib.dpgo_g2o_count(filename.encode(), ctypes.byref(dim))
    if m <= 0:
        return None  # error or empty: fall back for the precise exception
    d = dim.value
    p1 = np.empty(m, np.int32)
    p2 = np.empty(m, np.int32)
    R = np.empty(m * d * d, np.float64)
    t = np.empty(m * d, np.float64)
    kappa = np.empty(m, np.float64)
    tau = np.empty(m, np.float64)
    fixed = np.empty(m, np.uint8)
    n = lib.dpgo_g2o_parse(filename.encode(), d, m, p1, p2, R, t, kappa, tau, fixed)
    if n <= 0:
        return None
    edges = EdgeArrays(
        r1=np.zeros(m, np.int32),
        r2=np.zeros(m, np.int32),
        p1=p1,
        p2=p2,
        R=R.reshape(m, d, d),
        t=t.reshape(m, d),
        kappa=kappa,
        tau=tau,
        weight=np.ones(m),
        fixed_weight=fixed.astype(bool),
    )
    return edges, int(n)


def _quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    """Batched quaternion (x, y, z, w) -> rotation matrices (m, 3, 3).

    Matches Eigen::Quaterniond(w,x,y,z).toRotationMatrix(); Eigen normalizes
    implicitly only if the quaternion is unit — g2o files store unit
    quaternions, but we normalize defensively.
    """
    q = np.stack([qx, qy, qz, qw], axis=-1)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def read_g2o_arrays(filename: str) -> Tuple[EdgeArrays, int]:
    """Parse a .g2o file into struct-of-arrays form. Returns (edges, num_poses)."""
    native = _read_g2o_native(filename)
    if native is not None:
        return native
    return _read_g2o_arrays_py(filename)


def _read_g2o_arrays_py(filename: str) -> Tuple[EdgeArrays, int]:
    """Pure-numpy fallback parser."""
    se2_rows: List[str] = []
    se3_rows: List[str] = []
    with open(filename, "r") as f:
        for line in f:
            if line.startswith("EDGE_SE2 "):
                se2_rows.append(line[9:])
            elif line.startswith("EDGE_SE3:QUAT "):
                se3_rows.append(line[14:])
            elif line.startswith("VERTEX"):
                continue
            elif line.strip():
                tok = line.split(None, 1)[0]
                raise ValueError(f"unrecognized g2o record type: {tok!r}")

    if se2_rows and se3_rows:
        raise ValueError("mixed SE2/SE3 g2o files are not supported")
    if not se2_rows and not se3_rows:
        raise ValueError(f"no measurements found in {filename}")

    if se2_rows:
        # EDGE_SE2 i j dx dy dtheta I11 I12 I13 I22 I23 I33
        data = np.fromiter(" ".join(se2_rows).split(), dtype=np.float64).reshape(-1, 11)
        i = data[:, 0].astype(np.int64)
        j = data[:, 1].astype(np.int64)
        dx, dy, dtheta = data[:, 2], data[:, 3], data[:, 4]
        I11, I12, _, I22, _, I33 = (data[:, k] for k in range(5, 11))
        c, s = np.cos(dtheta), np.sin(dtheta)
        R = np.stack(
            [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
        )
        t = np.stack([dx, dy], axis=-1)
        # tau = 2 / trace(TranCov^{-1}), TranCov = [[I11, I12], [I12, I22]]
        det = I11 * I22 - I12 * I12
        tau = 2.0 / ((I11 + I22) / det)
        kappa = I33
    else:
        # EDGE_SE3:QUAT i j dx dy dz qx qy qz qw I11..I66 (upper triangle)
        data = np.fromiter(" ".join(se3_rows).split(), dtype=np.float64).reshape(-1, 30)
        i = data[:, 0].astype(np.int64)
        j = data[:, 1].astype(np.int64)
        t = data[:, 2:5].copy()
        R = _quat_to_rot(data[:, 5], data[:, 6], data[:, 7], data[:, 8])
        # Upper-triangular info entries, row-major: I11..I16, I22..I26, ...
        iu = np.triu_indices(6)
        info = np.zeros((data.shape[0], 6, 6))
        info[:, iu[0], iu[1]] = data[:, 9:30]
        info[:, iu[1], iu[0]] = data[:, 9:30]
        TranCov = info[:, :3, :3]
        RotCov = info[:, 3:, 3:]
        tau = 3.0 / np.trace(np.linalg.inv(TranCov), axis1=-2, axis2=-1)
        kappa = 3.0 / (2.0 * np.trace(np.linalg.inv(RotCov), axis1=-2, axis2=-1))

    m = i.shape[0]
    edges = EdgeArrays(
        r1=np.zeros(m, np.int32),
        r2=np.zeros(m, np.int32),
        p1=i.astype(np.int32),
        p2=j.astype(np.int32),
        R=R,
        t=t,
        kappa=kappa,
        tau=tau,
        weight=np.ones(m),
        fixed_weight=(i + 1 == j),
    )
    num_poses = int(max(i.max(), j.max())) + 1
    return edges, num_poses


def read_g2o_file(filename: str) -> Tuple[List[RelativeSEMeasurement], int]:
    """Parse a .g2o file into a list of measurements
    (reference: DPGO_utils.cpp:113-257). Returns (measurements, num_poses)."""
    edges, num_poses = read_g2o_arrays(filename)
    return edges.to_measurements(), num_poses


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), Eigen convention (the
    counterpart of dpgo_tpu/io/logger.py::_rot_to_quat, used by
    datasets.write_g2o)."""
    R = np.asarray(R, float)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])
