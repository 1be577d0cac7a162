"""Chordal initialization and odometry initialization.

The counterpart of dpgo_tpu/solvers/chordal.py (reference:
src/DPGO_solver.cpp:220-303, src/DPGO_utils.cpp:346-462): matrix-free
Jacobi-preconditioned CG on the normal equations in place of the
reference's SPQR solve, and the odometry chain as a prefix product.

Rotation stage:    min_{Rot_i in R^{d x d}, Rot_0 = I}  sum_e kappa_e ||Rot_i R_e - Rot_j||_F^2
Translation stage: min_{t_i, t_0 = 0}                  sum_e tau_e   ||t_j - t_i - Rot_i t_e||^2

The scatter-adds are index_add_; on a CUDA device those use atomics, so the
result varies in its last bits from run to run (an initialization only).
GNC edge weights are ignored here, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dpgo_tpu_torch.measurements import EdgeArrays, homogeneous
from dpgo_tpu_torch.ops import lifted


def _pcg(
    A: Callable, b: torch.Tensor, M: Callable, x0: torch.Tensor,
    tol: float, maxiter: int,
) -> torch.Tensor:
    """Minimal preconditioned conjugate gradients, stopped at
    ||r|| <= tol ||b|| or maxiter iterations. Reads the residual on the host
    once per iteration."""
    r = b - A(x0)
    z = M(r)
    p = z
    gamma = lifted.inner(r, z)
    tol_sq = (tol * tol) * lifted.inner(b, b)
    r_sq = lifted.inner(r, r)
    x = x0
    k = 0
    while k < maxiter and bool(r_sq > tol_sq):
        Ap = A(p)
        alpha = gamma / lifted.inner(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = lifted.inner(r, z)
        beta = gamma_new / gamma
        p = z + beta * p
        gamma = gamma_new
        r_sq = lifted.inner(r, r)
        k += 1
    return x


def _chordal_rotations(
    i: torch.Tensor,
    j: torch.Tensor,
    R: torch.Tensor,
    kappa: torch.Tensor,
    n: int,
    tol: float = 1e-10,
    maxiter: int = 1500,
) -> torch.Tensor:
    """Solve the anchored rotation least squares, returning (n, d, d) blocks
    (un-projected). Pose 0 is fixed to the identity (reference:
    DPGO_solver.cpp:232-249)."""
    d = R.shape[-1]
    dtype, dev = R.dtype, R.device
    free = (torch.arange(n, device=dev) > 0).to(dtype)[:, None, None]

    # Rotation connection Laplacian in block form (R R^T = I makes the
    # diagonal blocks scalar): L_ii = deg_i I, L_ij = -kappa_e R_e.
    deg = torch.zeros((n,), dtype=dtype, device=dev)
    deg.index_add_(0, i, kappa).index_add_(0, j, kappa)
    E = kappa[:, None, None] * R  # (m, d, d)
    m = i.shape[0]

    def laplacian(Rot):
        Rf = Rot.reshape(n, d * d)
        Ri = Rf[i].reshape(m, d, d)
        Rj = Rf[j].reshape(m, d, d)
        ci = (Rj @ E.transpose(-1, -2)).reshape(m, d * d)  # Rot_j E^T
        cj = (Ri @ E).reshape(m, d * d)  # Rot_i E
        outf = deg[:, None] * Rf
        outf.index_add_(0, i, ci, alpha=-1).index_add_(0, j, cj, alpha=-1)
        return outf.reshape(n, d, d)

    def A(Z):
        return laplacian(Z) * free

    # anchoring: Rot = embed(I at pose 0) + Z with Z on the free blocks
    anchor = torch.zeros((n, d, d), dtype=dtype, device=dev)
    anchor[0] = torch.eye(d, dtype=dtype, device=dev)
    b = -(laplacian(anchor) * free)

    # Jacobi preconditioner: the diagonal block at pose i is deg_i * I
    tiny = torch.finfo(dtype).tiny
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=tiny), 1.0)

    def M(Z):
        return Z * inv_deg[:, None, None] * free

    Z0 = torch.zeros((n, d, d), dtype=dtype, device=dev)
    return anchor + _pcg(A, b, M, Z0, tol=tol, maxiter=maxiter)


def _recover_translations(
    i: torch.Tensor,
    j: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    tau: torch.Tensor,
    Rot: torch.Tensor,
    n: int,
    tol: float = 1e-10,
    maxiter: int = 1500,
) -> torch.Tensor:
    """Solve the anchored translation least squares given rotations,
    returning (n, d). Pose 0 is fixed at the origin (reference:
    DPGO_utils.cpp:435-462)."""
    dtype, dev = R.dtype, R.device
    d = R.shape[-1]
    free = (torch.arange(n, device=dev) > 0).to(dtype)[:, None]

    c = (Rot[i] @ t[:, :, None])[:, :, 0]  # Rot_i t_e

    def laplacian(tv):
        res = (tv[j] - tv[i]) * tau[:, None]
        out = torch.zeros_like(tv)
        out.index_add_(0, j, res)
        out.index_add_(0, i, -res)
        return out

    def A(z):
        return laplacian(z) * free

    ct = c * tau[:, None]
    b = torch.zeros((n, d), dtype=dtype, device=dev)
    b.index_add_(0, j, ct).index_add_(0, i, -ct)
    b = b * free

    deg = torch.zeros((n,), dtype=dtype, device=dev)
    deg.index_add_(0, i, tau).index_add_(0, j, tau)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-300), 1.0)

    def M(z):
        return z * inv_deg[:, None] * free

    z0 = torch.zeros((n, d), dtype=dtype, device=dev)
    return _pcg(A, b, M, z0, tol=tol, maxiter=maxiter)


def chordal_initialization_arrays(
    edges: EdgeArrays,
    n: Optional[int] = None,
    dtype=torch.float64,
    tol: float = 1e-10,
    maxiter: int = 1500,
    cg_dtype=None,
    *,
    device,
) -> torch.Tensor:
    """Chordal initialization from edge arrays. Returns T: (n, d, d+1) in
    `dtype` on `device` (reference: DPGO_solver.cpp:220-269).

    cg_dtype: optionally run the two PCG stages in reduced precision (e.g.
    torch.float32); an initialization tolerates ~1e-4 accuracy. The SO(d)
    projection stays in `dtype`."""
    if edges.m == 0:
        raise ValueError("chordal initialization needs at least one edge")
    if n is None:
        n = int(max(edges.p1.max(), edges.p2.max())) + 1
    cg_dt = dtype if cg_dtype is None else cg_dtype

    def tensor(x, dt):
        return torch.as_tensor(x, device=device).to(dt)

    i = tensor(edges.p1, torch.int64)
    j = tensor(edges.p2, torch.int64)
    R = tensor(edges.R, cg_dt)
    t = tensor(edges.t, cg_dt)
    kappa = tensor(edges.kappa, cg_dt)
    tau = tensor(edges.tau, cg_dt)

    Rot = _chordal_rotations(i, j, R, kappa, n, tol=tol, maxiter=maxiter)
    Rot = lifted.project_rotation(Rot.to(dtype))
    tv = _recover_translations(
        i, j, R, t, tau, Rot.to(cg_dt), n, tol=tol, maxiter=maxiter
    )
    return torch.cat([Rot, tv[:, :, None].to(dtype)], dim=-1)


def _odometry_chain(T_start: torch.Tensor, rel_T: torch.Tensor) -> torch.Tensor:
    """Compose a chain of homogeneous relative transforms:
    T_k = T_start * rel_1 * ... * rel_k. rel_T: (n-1, dh, dh); returns
    (n, dh, dh).

    The inclusive prefix product runs as a doubling scan: in step s = 1, 2,
    4, ... every element k >= s becomes seq[k - s] @ seq[k], one batched
    product per step and ceil(log2 n) steps (17 at 100,000 poses) instead of
    n - 1 dependent products. The JAX package's associative_scan brackets
    the same product differently, and a sequential loop differently again,
    so the three agree to rounding, not in bits."""
    seq = torch.cat([T_start[None], rel_T], dim=0)
    n, s = seq.shape[0], 1
    while s < n:
        seq = torch.cat([seq[:s], seq[:-s] @ seq[s:]], dim=0)
        s *= 2
    return seq


def odometry_initialization_arrays(
    odometry: EdgeArrays,
    n: Optional[int] = None,
    partial_trajectory=None,
    dtype=torch.float64,
    *,
    device,
) -> torch.Tensor:
    """Odometry (dead-reckoning) initialization. Returns T: (n, d, d+1) in
    `dtype` on `device` (reference: DPGO_solver.cpp:271-303).

    partial_trajectory: optional (k, d, d+1) prefix to preserve; the
    remaining poses are extended by composing odometry from pose k-1."""
    if partial_trajectory is not None and torch.is_tensor(partial_trajectory):
        partial_trajectory = partial_trajectory.detach().cpu().numpy()
    if odometry.m == 0 and partial_trajectory is None:
        raise ValueError("empty odometry")
    d = odometry.d if odometry.m > 0 else np.asarray(partial_trajectory).shape[-2]
    if n is None:
        n = (int(odometry.p2.max()) + 1) if odometry.m > 0 \
            else len(partial_trajectory)

    # odometry edges must form the chain k -> k+1; sort by source index
    order = np.argsort(np.asarray(odometry.p1))
    Rh = homogeneous(odometry.R[order], odometry.t[order])

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    if partial_trajectory is not None and len(partial_trajectory) > 0:
        k = min(len(partial_trajectory), n)
        prefix = tensor(partial_trajectory[:k])
        if k >= n:
            return prefix
        Tk = lifted.se_homogeneous(prefix[k - 1])
        chain = _odometry_chain(Tk, tensor(Rh[k - 1: n - 1]))
        return torch.cat([prefix, chain[1:, :d, :]], dim=0)

    T0 = torch.eye(d + 1, dtype=dtype, device=device)
    return _odometry_chain(T0, tensor(Rh[: n - 1]))[:, :d, :]
