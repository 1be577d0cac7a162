"""The table of peaks and the operation and byte counts of the port's kernels.

Copied from chip_smoke.py (bound_ms, fused_bound): bytes and
operations counted from a call's shapes, each input byte read once and each
output byte written once, against the published peaks of one NVIDIA H100
SXM (NVIDIA's data sheet, dense rates, at its 700 W power limit): 3.35 TB/s
of HBM3 and 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """Least time on the card, and whether "bytes" or "operations" set it."""
    b, f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (b, "bytes") if b >= f else (f, "operations")


def edge_matvec_bound(m: int, n: int, w: int, dh: int) -> Tuple[float, str]:
    """One call of ops/edge_matvec.py's kernel on n rows of w = r * dh
    float32 and m gather-path edges: V, both E copies, the int64 indices
    and both row pointers read once, out read and written once; dh FMAs per
    output element, edge and direction."""
    nbytes = 4 * n * w + 2 * 4 * m * dh * dh + 2 * 8 * m + 2 * 4 * (n + 1) \
        + 2 * 4 * n * w
    return bound_s(nbytes, 2 * m * w * 2 * dh)

