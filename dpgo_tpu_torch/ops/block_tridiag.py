"""Block-tridiagonal SPD solves by cyclic reduction, and the exact banded
factor of (Q + shift I) built on them.

The counterpart of dpgo_tpu/ops/block_tridiag.py, the replacement for the
reference's Cholmod LDL^T preconditioner (reference:
src/PoseGraph.cpp:598-613, applied per tCG iteration at
src/QuadraticProblem.cpp:56-69):

  * factorize / solve: cyclic reduction of an SPD block-tridiagonal matrix,
    log2(n) levels of batched small products and inverses. With the
    odometry chain's coupling and every diagonal block this is the
    'tridiag' preconditioner.
  * make_banded_plan / build_banded_factor / solve_banded: the exact factor.
    A reverse Cuthill-McKee relabeling (scipy, host side) gives real pose
    graphs a small bandwidth; grouping s >= bandwidth relabeled poses into
    superblocks makes (Q + shift I) block-tridiagonal in (s*dh x s*dh)
    superblocks, which cyclic reduction then factors exactly.
  * the stacked variants: one plan per agent at a common s, factored and
    solved batched over the agents (the SPMD engine's 'auto' factor).

Every tensor function here takes optional leading batch axes: D (..., n, b,
b) gives one independent system per batch index. The superblock products
stay torch.matmul (the JAX package computes them outside any Pallas kernel).

System convention: M x = b with
    M[i, i]   = D[i]            (n, b, b)  SPD diagonal blocks
    M[i, i+1] = -E[i]           (n-1, b, b)
    M[i+1, i] = -E[i]^T
matching QuadraticData's (diag + shift, band_E) layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class CRLevel(NamedTuple):
    """One cyclic-reduction level's factors. Odd positions are eliminated,
    the ceil(m/2) even positions are kept for the next level."""

    odd_inv: torch.Tensor  # (..., n_odd, b, b)  D_odd^{-1}
    odd_L: torch.Tensor  # (..., n_odd, b, b)  M[odd, odd-1]
    odd_U: torch.Tensor  # (..., n_odd, b, b)  M[odd, odd+1] (0 at boundary)
    LD: torch.Tensor  # (..., n_even, b, b)  M[even, even-1] @ D_{even-1}^{-1}
    UD: torch.Tensor  # (..., n_even, b, b)  M[even, even+1] @ D_{even+1}^{-1}


class CRFactor(NamedTuple):
    levels: Tuple[CRLevel, ...]
    root_inv: torch.Tensor  # (..., 1, b, b) inverse of the final 1-block system

    @property
    def n(self) -> int:
        """Blocks of the factored system."""
        if not self.levels:
            return 1
        return self.levels[0].odd_inv.shape[-3] + self.levels[0].LD.shape[-3]

    def to(self, dtype: torch.dtype) -> "CRFactor":
        return CRFactor(
            levels=tuple(CRLevel(*(t.to(dtype) for t in lv))
                         for lv in self.levels),
            root_inv=self.root_inv.to(dtype),
        )

    def take(self, a) -> "CRFactor":
        """The factor of batch index `a` (leading axis)."""
        return CRFactor(
            levels=tuple(CRLevel(*(t[a] for t in lv)) for lv in self.levels),
            root_inv=self.root_inv[a],
        )


def _spd_inv(D: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse via Cholesky (small blocks, numerically stable)."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return torch.cholesky_solve(eye.expand(D.shape), torch.linalg.cholesky(D))


def _pad_blocks(A: torch.Tensor, front: int, back: int) -> torch.Tensor:
    """Zero blocks before and after, along the block axis (-3)."""
    return F.pad(A, (0, 0, 0, 0, front, back))


def factorize(D: torch.Tensor, E: torch.Tensor) -> CRFactor:
    """Cyclic-reduction factorization of the SPD block-tridiagonal matrix.

    D: (..., n, b, b) diagonal blocks; E: (..., n-1, b, b) with
    M[i, i+1] = -E[i]. n may be any size >= 1; there are ceil(log2(n))
    levels."""
    n = D.shape[-3]
    # upper coupling per position: U[i] = M[i, i+1] = -E[i], zero at i = n-1;
    # lower coupling L[i] = M[i, i-1] = -E[i-1]^T, zero at i = 0
    if n > 1:
        U = _pad_blocks(-E, 0, 1)
        L = _pad_blocks(-E.transpose(-1, -2), 1, 0)
    else:
        U = L = torch.zeros_like(D)

    levels: List[CRLevel] = []
    while n > 1:
        n_odd = n // 2
        n_even = n - n_odd
        odd_inv = _spd_inv(D[..., 1::2, :, :])
        odd_L = L[..., 1::2, :, :]
        odd_U = U[..., 1::2, :, :]

        # odd neighbors of kept (even) positions, zero blocks out of range:
        # the left one of even 2k is odd index k-1 (pad slot k), the right
        # one odd index k (pad slot k+1)
        inv_pad = _pad_blocks(odd_inv, 1, 1)
        invL = inv_pad[..., :n_even, :, :]
        invR = inv_pad[..., 1:n_even + 1, :, :]
        LD = L[..., 0::2, :, :] @ invL
        UD = U[..., 0::2, :, :] @ invR
        levels.append(CRLevel(odd_inv=odd_inv, odd_L=odd_L, odd_U=odd_U,
                              LD=LD, UD=UD))

        # reduced system on the even positions
        oL = _pad_blocks(odd_L, 1, 1)[..., :n_even, :, :]  # L of left odd nbr
        oU = _pad_blocks(odd_U, 0, 1)[..., :n_even, :, :]  # U of right odd nbr
        oU_left = _pad_blocks(odd_U, 1, 1)[..., :n_even, :, :]
        oL_right = _pad_blocks(odd_L, 0, 1)[..., :n_even, :, :]
        D = D[..., 0::2, :, :] - LD @ oU_left - UD @ oL_right
        # the reduced L[0] / U[last] stay zero blocks: LD[0] multiplies a
        # zero L[0], and the last UD a zero U
        L, U, n = -(LD @ oL), -(UD @ oU), n_even

    return CRFactor(levels=tuple(levels), root_inv=_spd_inv(D))


def solve(factor: CRFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given a CRFactor. b: (..., n, b, r) block right-hand
    sides, with the factor's batch axes."""
    # down-sweep: fold the eliminated odd blocks into the kept even equations
    odd_rhs = []
    for lv in factor.levels:
        n_even = b.shape[-3] - b.shape[-3] // 2
        b_odd = b[..., 1::2, :, :]
        odd_rhs.append(b_odd)
        pad = _pad_blocks(b_odd, 1, 1)
        b = (b[..., 0::2, :, :] - lv.LD @ pad[..., :n_even, :, :]
             - lv.UD @ pad[..., 1:n_even + 1, :, :])

    x = factor.root_inv @ b

    # up-sweep: recover the eliminated odd blocks, interleave with the evens
    for lv, b_odd in zip(reversed(factor.levels), reversed(odd_rhs)):
        n_odd = b_odd.shape[-3]
        n_even = x.shape[-3]
        # odd position 2k+1 has even neighbors 2k (left) and 2k+2 (right)
        x_pad = _pad_blocks(x, 0, 1)
        rhs = (b_odd - lv.odd_L @ x_pad[..., :n_odd, :, :]
               - lv.odd_U @ x_pad[..., 1:n_odd + 1, :, :])
        out = x.new_empty(x.shape[:-3] + (n_even + n_odd,) + x.shape[-2:])
        out[..., 0::2, :, :] = x
        out[..., 1::2, :, :] = lv.odd_inv @ rhs
        x = out
    return x


@dataclasses.dataclass(frozen=True)
class BandedFactor:
    """Exact banded factorization of (Q + shift I) under an RCM relabeling,
    optionally batched (leading axes on perm, invp and the factor).

    perm: (..., nb*s) new -> old pose id (the padded tail repeats pose 0);
    invp: (..., n) old -> new."""

    s: int
    nb: int
    n: int
    perm: torch.Tensor
    invp: torch.Tensor
    cr: CRFactor

    def to(self, dtype: torch.dtype) -> "BandedFactor":
        return dataclasses.replace(self, cr=self.cr.to(dtype))

    def take(self, a) -> "BandedFactor":
        """The factor of batch index `a` (leading axis)."""
        return dataclasses.replace(self, perm=self.perm[a],
                                   invp=self.invp[a], cr=self.cr.take(a))


class BandedPlan(NamedTuple):
    """Host-side static scatter plan for build_banded_factor (all numpy)."""

    s: int
    nb: int
    n: int
    dh: int
    bandwidth: int
    perm: np.ndarray  # (nb*s,) new -> old (clipped)
    invp: np.ndarray  # (n,) old -> new
    diag_k: np.ndarray  # (n,) superblock of each (old) pose
    diag_r: np.ndarray  # (n,) row offset (poses) within the superblock
    pad_diag: np.ndarray  # (nb, s*dh) 1.0 on padding rows' diagonal
    # per-edge placements; masked entries carry weight 0 and clipped indices
    ek_fwd: np.ndarray  # (m,) D-superblock of the (a, b) entry
    er_fwd: np.ndarray  # (m,) row (pose) offset of a
    ec_fwd: np.ndarray  # (m,) col (pose) offset of b
    em_fwd: np.ndarray  # (m,) 1.0 iff same-superblock
    ek_cpl: np.ndarray  # (m,) C-superblock index of the coupling entry
    er_cpl: np.ndarray  # (m,) row (pose) offset within the coupling block
    ec_cpl: np.ndarray  # (m,) col (pose) offset
    et_cpl: np.ndarray  # (m,) 1.0 iff the coupling entry holds -E^T (else -E)
    em_cpl: np.ndarray  # (m,) 1.0 iff adjacent-superblock
    dropped: int  # edges spanning >= 2 superblocks (0 when s >= bandwidth)


def make_banded_plan(
    i, j, n: int, dh: int, s: Optional[int] = None, max_block: int = 1024
) -> Optional[BandedPlan]:
    """RCM-relabel the pose graph and plan the superblock scatter (host
    side). Returns None when the relabeled bandwidth is too large for an
    exact factor of acceptable block size (s*dh > max_block): factor memory
    is ~5*n*s*dh^2 floats, linear in s."""
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee as _rcm

    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    m = len(i)
    A = _sp.coo_matrix((np.ones(m), (i, j)), shape=(n, n))
    A = (A + A.T).tocsr()
    perm_no = np.asarray(_rcm(A, symmetric_mode=True), np.int64)  # new -> old
    invp = np.empty(n, np.int64)
    invp[perm_no] = np.arange(n)
    a = invp[i]
    b = invp[j]
    bw = int(np.abs(a - b).max()) if m else 1
    if s is None:
        s = max(8, ((bw + 7) // 8) * 8)
    if s * dh > max_block:
        return None
    nb = (n + s - 1) // s
    ka, ra = a // s, a % s
    kb, rb = b // s, b % s
    same = ka == kb
    fwd = kb == ka + 1  # (a, b) sits in M[ka, ka+1]
    bwd = ka == kb + 1  # (b, a) sits in M[kb, kb+1], transposed block
    adj = fwd | bwd
    dropped = int(m - same.sum() - adj.sum())
    pad_diag = np.zeros((nb, s * dh))
    flat_pad = np.arange(nb * s) >= n
    pad_diag.reshape(nb, s, dh)[flat_pad.reshape(nb, s)] = 1.0
    perm_pad = np.concatenate([perm_no, np.zeros(nb * s - n, np.int64)])
    zero = np.zeros(m, np.int64)
    return BandedPlan(
        s=s, nb=nb, n=n, dh=dh, bandwidth=bw,
        perm=perm_pad, invp=invp,
        diag_k=invp // s, diag_r=invp % s, pad_diag=pad_diag,
        ek_fwd=np.where(same, ka, zero),
        er_fwd=np.where(same, ra, zero),
        ec_fwd=np.where(same, rb, zero),
        em_fwd=same.astype(np.float64),
        ek_cpl=np.where(fwd, ka, np.where(bwd, kb, zero)),
        er_cpl=np.where(fwd, ra, np.where(bwd, rb, zero)),
        ec_cpl=np.where(fwd, rb, np.where(bwd, ra, zero)),
        et_cpl=bwd.astype(np.float64),
        em_cpl=adj.astype(np.float64),
        dropped=dropped,
    )


class StackedBandedPlan(NamedTuple):
    """Per-agent banded plans with a common superblock size (uniform shapes,
    so the factor assembly and solve batch over the agent axis). Array
    fields carry a leading (A,) axis; the statics (s, nb, n, dh) are shared.
    Gives every agent of the SPMD engine the exact banded preconditioner
    (reference parity: each PGOAgent owns a full Cholmod LDL^T of its local
    Q, PoseGraph.cpp:598-613)."""

    s: int
    nb: int
    n: int
    dh: int
    pad_diag: np.ndarray  # (nb, s*dh): identical for every agent (same n)
    perm: np.ndarray  # (A, nb*s)
    invp: np.ndarray  # (A, n)
    diag_k: np.ndarray  # (A, n)
    diag_r: np.ndarray  # (A, n)
    ek_fwd: np.ndarray  # (A, m)
    er_fwd: np.ndarray
    ec_fwd: np.ndarray
    em_fwd: np.ndarray
    ek_cpl: np.ndarray
    er_cpl: np.ndarray
    ec_cpl: np.ndarray
    et_cpl: np.ndarray
    em_cpl: np.ndarray


_STACKED_ARRAY_FIELDS = (
    "perm", "invp", "diag_k", "diag_r", "ek_fwd", "er_fwd", "ec_fwd",
    "em_fwd", "ek_cpl", "er_cpl", "ec_cpl", "et_cpl", "em_cpl",
)


def make_banded_plans_stacked(
    i_stk, j_stk, n: int, dh: int, max_block: int = 1024
) -> Optional[StackedBandedPlan]:
    """Host side: one banded plan per agent at a common superblock size
    s = max over the agents' RCM bandwidths (no agent drops a coupling entry
    and all shapes are uniform). None when the common s would exceed
    max_block/dh. Padding edges (i = j = 0, weight 0) only add a harmless
    self-loop to the RCM graph; their E blocks are zero."""
    i_stk = np.asarray(i_stk)
    j_stk = np.asarray(j_stk)
    plans = []
    s = 8
    for a in range(i_stk.shape[0]):
        p = make_banded_plan(i_stk[a], j_stk[a], n, dh, max_block=max_block)
        if p is None:
            return None
        s = max(s, p.s)
        plans.append(p)
    if s * dh > max_block:
        return None
    plans = [
        p if p.s == s
        else make_banded_plan(i_stk[a], j_stk[a], n, dh, s=s,
                              max_block=max_block)
        for a, p in enumerate(plans)
    ]
    if any(p is None or p.dropped for p in plans):  # cannot happen: s >= bw
        return None
    return StackedBandedPlan(
        s=s, nb=plans[0].nb, n=n, dh=dh, pad_diag=plans[0].pad_diag,
        **{f: np.stack([getattr(p, f) for p in plans])
           for f in _STACKED_ARRAY_FIELDS},
    )


def _build_banded(plan, shifted_diag: torch.Tensor,
                  E_edges: torch.Tensor) -> BandedFactor:
    """Assemble and factor the superblock-tridiagonal matrices of A agents:
    `plan` holds (A, ...) index arrays (a StackedBandedPlan, or a BandedPlan
    with its arrays given a leading axis), shifted_diag (A, n, dh, dh),
    E_edges (A, m, dh, dh). Only the block values are runtime data."""
    s, nb, n, dh = plan.s, plan.nb, plan.n, plan.dh
    A = shifted_diag.shape[0]
    dt, dev = shifted_diag.dtype, shifted_diag.device
    sdh = s * dh
    ar = torch.arange(dh, device=dev)
    agent = torch.arange(A, device=dev)[:, None]

    def idx(name):
        return torch.as_tensor(np.asarray(getattr(plan, name)), device=dev)

    def blk_idx(k, r, c, nblk):
        """(A, v) superblock ids + pose row/col offsets -> element indices
        (flat superblock over the agents, row, col), broadcast to
        (A, v, dh, dh)."""
        K = (agent * nblk + k)[..., None, None]
        R = (r[..., None] * dh + ar)[..., :, None]
        C = (c[..., None] * dh + ar)[..., None, :]
        return torch.broadcast_tensors(K, R, C)

    def vals(name):
        return torch.as_tensor(np.asarray(getattr(plan, name)), dtype=dt,
                               device=dev)[..., None, None]

    D = torch.zeros((A * nb, sdh, sdh), dtype=dt, device=dev)
    # diagonal blocks of every real pose, then 1.0 on padding rows
    D.index_put_(blk_idx(idx("diag_k"), idx("diag_r"), idx("diag_r"), nb),
                 shifted_diag, accumulate=True)
    D = D.reshape(A, nb, sdh, sdh) + torch.diag_embed(
        torch.as_tensor(plan.pad_diag, dtype=dt, device=dev))

    # same-superblock entries: (a, b) = -E and its mirror (b, a) = -E^T;
    # swapping the row/col index arrays transposes the placement, so the
    # mirror's value stays -E
    Df = D.reshape(A * nb, sdh, sdh)
    K, R, C = blk_idx(idx("ek_fwd"), idx("er_fwd"), idx("ec_fwd"), nb)
    val = -E_edges * vals("em_fwd")
    Df.index_put_((K, R, C), val, accumulate=True)
    Df.index_put_((K, C, R), val, accumulate=True)

    # adjacent-superblock coupling C[k] = M[k, k+1]; its mirror
    # M[k+1, k] = C[k]^T is implied by factorize's convention
    ncb = max(nb - 1, 1)
    val = torch.where(vals("et_cpl") > 0, -E_edges.transpose(-1, -2),
                      -E_edges) * vals("em_cpl")
    Cb = torch.zeros((A * ncb, sdh, sdh), dtype=dt, device=dev)
    Cb.index_put_(blk_idx(idx("ek_cpl"), idx("er_cpl"), idx("ec_cpl"), ncb),
                  val, accumulate=True)
    Cb = Cb.reshape(A, ncb, sdh, sdh)

    # factorize expects M[k, k+1] = -E_sb[k]
    return BandedFactor(s=s, nb=nb, n=n, perm=idx("perm"), invp=idx("invp"),
                        cr=factorize(D, -Cb[:, :nb - 1]))


def build_banded_factor(
    plan: BandedPlan, shifted_diag: torch.Tensor, E_edges: torch.Tensor
) -> BandedFactor:
    """Assemble the superblock-tridiagonal matrix and factor it.

    shifted_diag: (n, dh, dh) = Q's diagonal blocks + shift I (old labels).
    E_edges: (m, dh, dh) per-edge E_k = T_k Omega_k, so Q[i, j] = -E_k and
    Q[j, i] = -E_k^T (weights folded in: zero-weight rows vanish)."""
    one = plan._replace(**{f: np.asarray(getattr(plan, f))[None]
                           for f in _STACKED_ARRAY_FIELDS})
    return _build_banded(one, shifted_diag[None], E_edges[None]).take(0)


def build_banded_factor_stacked(
    splan: StackedBandedPlan,
    shifted_diag: torch.Tensor,  # (A, n, dh, dh)
    E_edges: torch.Tensor,  # (A, m, dh, dh)
) -> BandedFactor:
    """build_banded_factor batched over the agent axis: a BandedFactor whose
    tensors carry a leading (A,) axis (index it for one agent's factor)."""
    return _build_banded(splan, shifted_diag, E_edges)


def solve_banded(bf: BandedFactor, V: torch.Tensor) -> torch.Tensor:
    """Apply the banded factor to row-vector blocks: out M = V per pose block
    (M is scalar-symmetric). V: (..., n, r, dh) with the factor's batch
    axes, or the same rows flattened into (B*n, r, dh) for a batched
    factor. Permute to RCM order, stack each superblock's s pose blocks into
    one (s*dh, r) right-hand side, run the cyclic-reduction solve, permute
    back."""
    batch = tuple(bf.perm.shape[:-1])
    shape = V.shape
    r, dh = shape[-2], shape[-1]
    V = V.reshape(batch + (bf.n, r, dh))
    # the perm tail (padding rows) repeats pose 0: those right-hand sides hit
    # decoupled identity rows of M, and invp drops their solutions
    Vp = torch.take_along_dim(V, bf.perm[..., None, None], dim=-3)
    rhs = Vp.reshape(batch + (bf.nb, bf.s, r, dh)).transpose(-1, -2)
    x = solve(bf.cr, rhs.reshape(batch + (bf.nb, bf.s * dh, r)))
    x = x.reshape(batch + (bf.nb, bf.s, dh, r)).transpose(-1, -2)
    x = x.reshape(batch + (bf.nb * bf.s, r, dh))
    return torch.take_along_dim(x, bf.invp[..., None, None], dim=-3).reshape(shape)
