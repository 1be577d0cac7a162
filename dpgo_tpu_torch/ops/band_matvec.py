"""The diagonal and band-lane products of the Hessian matvec as one op.

For V (n, r, dh), the diagonal blocks diag (n, dh, dh), the band lanes
band_E (L, n, dh, dh) (lane l holds the E blocks of the edges
(i, i + offsets[l]) at row i; None without lanes), blk = block_rows or n
and loc_i = i % blk:

    out[i] = V[i] @ diag[i]
             - sum_l [0 <= loc_i + d_l < blk] V[i + d_l] @ band_E[l, i]^T
             - sum_l [0 <= loc_i - d_l < blk] V[i - d_l] @ band_E[l, i - d_l]

the part of quadratic.q_matvec before its gather-path edge term (the
counterpart of dpgo_tpu/quadratic.py:561-592). Offsets may be negative; a
batch's lanes never reach across its blocks of block_rows rows.

  band_matvec(V, diag, band_E, offsets, block_rows)            # the kernel
  band_matvec_reference(V, diag, band_E, offsets, block_rows)  # plain

band_matvec launches the kernel of csrc/band_matvec.cu into a fresh `out`
(ops._build.launch counts it); it raises on what the kernel does not take,
CPU tensors included, and never falls back: callers route by
ops._build.on_card. The offsets go to the kernel by value: no copy to the
device, no host read, no allocation beyond `out`.
"""

from __future__ import annotations

import ctypes

import torch

from dpgo_tpu_torch.ops import _build

# Lanes the kernel takes (quadratic.choose_band_offsets plans at most 16).
MAX_LANES = 16


def band_matvec_reference(V: torch.Tensor, diag: torch.Tensor, band_E,
                          offsets: tuple, block_rows: int = 0) -> torch.Tensor:
    """Plain version: one batched product against the diagonal blocks, then
    the band lanes fused across all offsets (two row gathers and two batched
    products)."""
    n, r, dh = V.shape
    out = V @ diag
    if band_E is not None:
        # Band lanes, fused across all offsets: lane l holds the E blocks of
        # edges (i, i + delta_l) at row i (zeros elsewhere).
        L = len(offsets)
        # filled on the device, not copied from the host: a CUDA graph
        # may hold this product (the certificate's refinement step)
        offs = torch.stack([torch.full((), o, dtype=torch.int64,
                                       device=V.device) for o in offsets])
        iota = torch.arange(n, device=V.device)
        # row within its block, and the block's first row
        blk = block_rows or n
        loc = iota % blk
        base = iota - loc
        # tail side: out[i] -= sum_l V[i + delta_l] @ E[l, i]^T. Offsets may
        # be negative (backward edges stay on their lane un-flipped: the
        # lifted translation cost is not invariant under edge reversal).
        # Rows whose i + delta_l falls outside their block have zero E
        # blocks, so the clipped gather's garbage is annihilated.
        up = torch.clamp(loc[None, :] + offs[:, None], 0, blk - 1) + base
        Vs = V[up.reshape(-1)].reshape(L, n, r, dh)
        out = out - (Vs @ band_E.transpose(-1, -2)).sum(dim=0)
        # head side: out[j] -= sum_l (V @ E)[l, j - delta_l]; j - delta_l
        # outside its block gathers the appended zero row.
        C = (V[None] @ band_E).reshape(L * n, r, dh)
        C = torch.cat([C, C.new_zeros((1, r, dh))])
        down = loc[None, :] - offs[:, None]  # (L, n)
        flat = torch.where(
            (down >= 0) & (down < blk),
            torch.arange(L, device=V.device)[:, None] * n + base + down,
            L * n,
        )
        out = out - C[flat.reshape(-1)].reshape(L, n, r, dh).sum(dim=0)
    return out


def _check(V, diag, band_E, offsets, block_rows) -> int:
    """Raise on anything the kernel does not take; returns the lane count."""
    tensors = (V, diag) if band_E is None else (V, diag, band_E)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the kernel takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if V.dim() != 3:
        raise ValueError(f"V must be (n, r, dh), got {tuple(V.shape)}")
    n, r, dh = V.shape
    if dh not in (3, 4):
        raise ValueError(f"blocks of dh in (3, 4) columns, got dh={dh}")
    if tuple(diag.shape) != (n, dh, dh):
        raise ValueError(f"diag must be ({n}, {dh}, {dh}), got "
                         f"{tuple(diag.shape)}")
    L = len(offsets) if band_E is not None else 0
    if L > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} band lanes, got {L}")
    if band_E is not None and tuple(band_E.shape) != (L, n, dh, dh):
        raise ValueError(f"band_E must be ({L}, {n}, {dh}, {dh}), got "
                         f"{tuple(band_E.shape)}")
    if block_rows < 0 or (block_rows and n % block_rows):
        raise ValueError(f"{n} rows are not whole blocks of {block_rows}")
    if any(t.device != V.device for t in tensors):
        raise ValueError(f"all tensors must be on {V.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")
    return L


def band_matvec(V: torch.Tensor, diag: torch.Tensor, band_E, offsets: tuple,
                block_rows: int = 0) -> torch.Tensor:
    """The diagonal and band-lane products of V into a fresh (n, r, dh)
    tensor, by the kernel of csrc/band_matvec.cu."""
    L = _check(V, diag, band_E, offsets, block_rows)
    out = torch.empty_like(V)
    n, r, dh = V.shape
    _build.launch(
        "band_matvec", V.device, n, V.data_ptr(), diag.data_ptr(),
        None if band_E is None else band_E.data_ptr(),
        (ctypes.c_int * MAX_LANES)(*offsets[:L]), L, out.data_ptr(), n, r, dh,
        block_rows or n)
    return out
