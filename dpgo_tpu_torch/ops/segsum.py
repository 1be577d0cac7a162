"""CSR segment sum (sorted scatter-add) over row vectors.

The counterpart of dpgo_tpu/ops/pallas_segsum.py. The contributions of the
gather-path edges are pre-sorted by destination once, when the plans are
attached (quadratic.attach_csr_plans), so each output row owns a contiguous
range of contribution rows: out[r] = sum(contrib[row_ptr[r]:row_ptr[r+1]]).

  plan = make_segsum_plan(dest_sorted, n, device=...)   # host, once
  out  = segment_sum_csr(contrib_sorted, plan)          # kernel on the card
  out  = segment_sum_reference(contrib_sorted, plan)    # plain version

On a CUDA tensor segment_sum_csr launches the hand-written kernel of
csrc/segsum.cu and counts the launch in LAUNCHES; on a CPU tensor it calls
the plain version. It never falls back from the card to the plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Launches of the CUDA kernel in this process; chip_smoke.py reads it to show
# which kernels a run went through.
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class SegsumPlan:
    """Static plan for a sorted segment sum.

    n       : number of output rows
    dest    : (m,) int64 sorted destination rows (for the plain version)
    row_ptr : (n+1,) int32 CSR offsets: row r owns [row_ptr[r], row_ptr[r+1])
    """

    n: int
    dest: torch.Tensor
    row_ptr: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.dest.shape[0])


def make_segsum_plan(dest_sorted, n: int, *, device) -> SegsumPlan:
    """Build the plan from sorted destination rows (host side)."""
    dest = np.asarray(dest_sorted, np.int64)
    if np.any(np.diff(dest) < 0):
        raise ValueError("destinations must be sorted")
    if len(dest) and (dest[0] < 0 or dest[-1] >= n):
        raise ValueError(f"destinations must lie in [0, {n})")
    if len(dest) >= 2**31:
        raise ValueError("at most 2**31 - 1 contributions")
    row_ptr = np.searchsorted(dest, np.arange(n + 1), side="left")
    return SegsumPlan(
        n=n,
        dest=torch.as_tensor(dest, device=device),
        row_ptr=torch.as_tensor(row_ptr.astype(np.int32), device=device),
    )


def segment_sum_reference(contrib: torch.Tensor, plan: SegsumPlan) -> torch.Tensor:
    """Plain version: scatter-add with index_add_ (the counterpart of
    pallas_segsum.segment_sum_xla)."""
    out = torch.zeros(
        (plan.n, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device
    )
    return out.index_add_(0, plan.dest, contrib)


def segment_sum_csr(contrib: torch.Tensor, plan: SegsumPlan) -> torch.Tensor:
    """Segment sum of destination-sorted contributions (m, w) -> (n, w).

    CUDA tensors go through the kernel of csrc/segsum.cu (float32 only, the
    one type the matvec sends); CPU tensors through segment_sum_reference."""
    global LAUNCHES
    if contrib.device.type == "cpu":
        return segment_sum_reference(contrib, plan)
    if contrib.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {contrib.device}")
    if plan.row_ptr.device != contrib.device:
        raise ValueError(
            f"plan on {plan.row_ptr.device}, contributions on {contrib.device}"
        )
    if contrib.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {contrib.dtype}")
    if contrib.dim() != 2 or contrib.shape[0] != plan.m:
        raise ValueError(
            f"contributions must be ({plan.m}, w), got {tuple(contrib.shape)}"
        )
    if not contrib.is_contiguous():
        raise ValueError("contributions must be contiguous")
    n, w = plan.n, int(contrib.shape[1])
    out = torch.empty((n, w), dtype=contrib.dtype, device=contrib.device)
    if n == 0 or w == 0:
        return out
    from dpgo_tpu_torch.ops import _build

    rc = _build.load().dpgo_segsum_csr_f32(
        contrib.data_ptr(), plan.row_ptr.data_ptr(), out.data_ptr(), n, w,
        torch.cuda.current_stream(contrib.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
