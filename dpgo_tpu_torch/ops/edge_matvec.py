"""The gather-path edge terms of the Hessian matvec as one fused op.

For float32 rows Vf, out (n, w = r*dh) and the CSR plans of
quadratic.CSRPlans (edges pre-sorted by each destination):

    out[j] -= sum_{e in plan_j row j} V[src_by_j[e]] @ E_by_j[e]      (->j)
    out[i] -= sum_{e in plan_i row i} V[dst_by_i[e]] @ E_by_i[e]^T    (->i)

the two segment-sum terms of quadratic.q_matvec's float32 CSR branch (the
counterpart of dpgo_tpu/quadratic.py:597-612). `out` is updated in place:
q_matvec always holds a fresh `out` there (V @ diag, then the band lanes).

  edge_matvec(out, Vf, csr)            # the kernel on the card
  edge_matvec_reference(out, Vf, csr)  # plain version

On CUDA tensors edge_matvec launches the kernel of csrc/edge_matvec.cu, one
launch for both terms, and counts it in LAUNCHES; on CPU tensors it calls
the plain version. It never falls back from the card to the plain version.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.ops import segsum

# Launches of the CUDA kernel in this process; chip_smoke.py reads it to show
# that the solve went through the kernel.
LAUNCHES = 0


def edge_matvec_reference(out: torch.Tensor, Vf: torch.Tensor, csr) -> torch.Tensor:
    """Plain version: row gathers, batched (r x dh)(dh x dh) products and two
    plain segment sums (segsum.segment_sum_reference)."""
    m, dh = csr.E_by_j.shape[0], csr.E_by_j.shape[-1]
    r = Vf.shape[1] // dh
    ci = (Vf[csr.src_by_j].reshape(m, r, dh) @ csr.E_by_j).reshape(m, r * dh)
    cj = (Vf[csr.dst_by_i].reshape(m, r, dh)
          @ csr.E_by_i.transpose(-1, -2)).reshape(m, r * dh)
    out -= segsum.segment_sum_reference(ci, csr.plan_j)
    out -= segsum.segment_sum_reference(cj, csr.plan_i)
    return out


def _check(out: torch.Tensor, Vf: torch.Tensor, csr) -> None:
    """Raise on anything the kernel does not take."""
    if Vf.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {Vf.dtype}, {out.dtype}")
    if Vf.dim() != 2 or out.shape != Vf.shape:
        raise ValueError(f"Vf and out must be one (n, w) shape, got "
                         f"{tuple(Vf.shape)} and {tuple(out.shape)}")
    n, w = Vf.shape
    m, dh = csr.E_by_j.shape[0], csr.E_by_j.shape[-1]
    if dh not in (3, 4) or w % dh:
        raise ValueError(f"rows of r * dh floats with dh in (3, 4), got w={w}, "
                         f"dh={dh}")
    for name, E in (("E_by_j", csr.E_by_j), ("E_by_i", csr.E_by_i)):
        if E.dtype != torch.float32 or tuple(E.shape) != (m, dh, dh):
            raise ValueError(f"{name} must be float32 ({m}, {dh}, {dh}), got "
                             f"{E.dtype} {tuple(E.shape)}")
    for name, idx in (("src_by_j", csr.src_by_j), ("dst_by_i", csr.dst_by_i)):
        if idx.dtype != torch.int64 or tuple(idx.shape) != (m,):
            raise ValueError(f"{name} must be int64 ({m},), got {idx.dtype} "
                             f"{tuple(idx.shape)}")
    for name, plan in (("plan_j", csr.plan_j), ("plan_i", csr.plan_i)):
        if plan.n != n or plan.m != m:
            raise ValueError(f"{name} is for {plan.n} rows and {plan.m} edges, "
                             f"not {n} and {m}")
    tensors = (out, Vf, csr.src_by_j, csr.E_by_j, csr.plan_j.row_ptr,
               csr.dst_by_i, csr.E_by_i, csr.plan_i.row_ptr)
    if any(t.device != Vf.device for t in tensors):
        raise ValueError(f"all tensors must be on {Vf.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")
    if Vf.numel() and (out.data_ptr() < Vf.data_ptr() + 4 * Vf.numel()
                       and Vf.data_ptr() < out.data_ptr() + 4 * out.numel()):
        raise ValueError("out must not overlap Vf")


def edge_matvec(out: torch.Tensor, Vf: torch.Tensor, csr) -> torch.Tensor:
    """out -= both edge terms of Vf, in place; returns out.

    CUDA tensors go through the kernel of csrc/edge_matvec.cu (float32 only,
    the one type the matvec sends); CPU tensors through
    edge_matvec_reference."""
    global LAUNCHES
    _check(out, Vf, csr)
    if Vf.device.type == "cpu":
        return edge_matvec_reference(out, Vf, csr)
    if Vf.device.type != "cuda":
        raise ValueError(f"no edge-matvec kernel for device {Vf.device}")
    (n, w), dh = Vf.shape, csr.E_by_j.shape[-1]
    if n == 0 or csr.E_by_j.shape[0] == 0:
        return out
    from dpgo_tpu_torch.ops import _build

    rc = _build.load().dpgo_edge_matvec_f32(
        Vf.data_ptr(), csr.src_by_j.data_ptr(), csr.E_by_j.data_ptr(),
        csr.plan_j.row_ptr.data_ptr(), csr.dst_by_i.data_ptr(),
        csr.E_by_i.data_ptr(), csr.plan_i.row_ptr.data_ptr(), out.data_ptr(),
        n, w // dh, dh, torch.cuda.current_stream(Vf.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"edge-matvec kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
