"""Chordal initialization and odometry initialization.

The counterpart of dpgo_tpu/solvers/chordal.py (reference:
src/DPGO_solver.cpp:220-303, src/DPGO_utils.cpp:346-462): matrix-free
Jacobi-preconditioned CG on the normal equations in place of the
reference's SPQR solve, and the odometry chain as a prefix product.

Rotation stage:    min_{Rot_i in R^{d x d}, Rot_0 = I}  sum_e kappa_e ||Rot_i R_e - Rot_j||_F^2
Translation stage: min_{t_i, t_0 = 0}                  sum_e tau_e   ||t_j - t_i - Rot_i t_e||^2

Where ops._build.on_card holds (float32 on the card), both stages apply
their operator free * L through the kernel of ops/chordal_laplacian.py,
over one plan of the graph built per initialization (span "chordal.plan"):
one launch per PCG step run, plus the rotation stage's right-hand side
and each stage's initial residual. Everywhere else (the CPU, float64) the
operator is the plain composition below, whose scatter-adds are index_add_;
on a CUDA device those use atomics, so the result varies in its last bits
from run to run (an initialization only). GNC edge weights are ignored
here, as in the reference.

Each PCG stage is a span of trace.py ("chordal.rotations",
"chordal.translations"), and so is the SO(d) projection between them
("chordal.project"). Each stage's PCG runs in blocks of BLOCK masked
steps with one host read a block (_pcg); on CUDA each step is a replay of
a CUDA graph captured once per stage. trace.COUNTS counts the
initializations ("chordal.solves"), the PCG iterations ("chordal.pcg_iters",
the plain loop's count), the steps run, frozen ones included
("chordal.pcg_steps"), the graph replays ("chordal.graph_replays") and the
reads, one a block ("sync.chordal.pcg").
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np
import torch

from dpgo_tpu_torch import trace
from dpgo_tpu_torch.measurements import EdgeArrays, homogeneous
from dpgo_tpu_torch.ops import _build, chordal_laplacian, lifted


# Steps a PCG block runs between two host reads of its state. 16 brings
# the 100k city's 1,229 reads (one an iteration) down to ~80 and a
# 3,500-pose city's 310 to ~20, while a stage runs at most 15 frozen
# steps (~1 ms at 100k poses).
BLOCK = 16


def _pcg(
    A: Callable, b: torch.Tensor, M: Callable, x0: torch.Tensor,
    tol: float, maxiter: int,
) -> torch.Tensor:
    """Minimal preconditioned conjugate gradients, stopped at
    ||r|| <= tol ||b|| or maxiter iterations, in blocks of BLOCK masked
    steps.

    The state (x, r, p, gamma, r_sq, the count k and active = r_sq > tol_sq
    and k < maxiter) lives in tensors on b's device that each step updates
    in place. A step computes the plain iteration, in the plain loop's
    order, and keeps it only where active holds, by selection: an active
    step is the plain loop's step bit for bit, and a frozen one changes
    nothing (after convergence gamma can be 0, and the frozen step's 0/0
    never reaches the state). After each block the host reads once whether
    the stage is done, and with it k, so the iterate and the count are the
    plain loop's. Where b is on CUDA the steps are replays of a CUDA graph
    (_graphed), elsewhere eager (_eager)."""
    r = b - A(x0)
    p = M(r)
    gamma = lifted.inner(r, p)
    tol_sq = (tol * tol) * lifted.inner(b, b)
    r_sq = lifted.inner(r, r)
    x = x0.clone()
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    active = (r_sq > tol_sq) & (k < maxiter)

    def step():
        Ap = A(p)
        alpha = gamma / lifted.inner(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        gamma_new = lifted.inner(r_new, z)
        beta = gamma_new / gamma
        p_new = z + beta * p
        r_sq_new = lifted.inner(r_new, r_new)
        for old, new in ((x, x_new), (r, r_new), (p, p_new),
                         (gamma, gamma_new), (r_sq, r_sq_new)):
            torch.where(active, new, old, out=old)
        k.add_(active)
        torch.logical_and(r_sq > tol_sq, k < maxiter, out=active)

    run = _graphed(step, b.device) if b.is_cuda else _eager(step)
    done = -1
    while done < 0:
        run(BLOCK)
        trace.COUNTS["chordal.pcg_steps"] += BLOCK
        done = trace.read("chordal.pcg", torch.where(active, -1, k))
    trace.COUNTS["chordal.pcg_iters"] += done
    return x


def _eager(step: Callable) -> Callable:
    """run(n): n calls of step."""
    def run(n):
        for _ in range(n):
            step()
    return run


# One capture stream per CUDA device, made once (torch.cuda.graph keeps one
# too): the allocator's blocks and cuBLAS's workspace for a stream are kept
# per stream, so a fresh stream for each capture would hold more of both.
_capture_streams: dict = {}


def _graphed(step: Callable, device: torch.device,
             replays: str = "chordal.graph_replays") -> Callable:
    """run(n) on CUDA: n steps as replays of one captured step.

    The first call runs one step eagerly on the capture stream (a real
    step, which also sets up cuBLAS's workspace and the caching allocator
    there), then captures one step and replays it n - 1 times; later calls
    replay it n times. CUDAGraph's capture_begin and capture_end are called
    directly: torch.cuda.graph would synchronize and empty the allocator's
    cache at every capture, two a chordal initialization. The capture is
    thread_local, so the agents' threads may use the card meanwhile. The
    launches made while capturing are taken back out of trace.COUNTS, and
    each replay counts those it contains; the counter `replays` counts the
    replays."""
    graph = None
    launched: collections.Counter = collections.Counter()

    def run(n):
        nonlocal graph
        if graph is None:
            main = torch.cuda.current_stream(device)
            side = _capture_streams.get(main.device)
            if side is None:
                side = _capture_streams[main.device] = torch.cuda.Stream(
                    main.device)
            side.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                step()
                before = trace.COUNTS.copy()
                graph.capture_begin(capture_error_mode="thread_local")
                step()
                graph.capture_end()
            main.wait_stream(side)
            launched.update(trace.COUNTS - before)
            trace.COUNTS.subtract(launched)
            n -= 1
        for _ in range(n):
            graph.replay()
        trace.COUNTS[replays] += n
        for name, count in launched.items():
            trace.COUNTS[name] += count * n
    return run


@trace.spanned("chordal.rotations")
def _chordal_rotations(
    i: torch.Tensor,
    j: torch.Tensor,
    R: torch.Tensor,
    kappa: torch.Tensor,
    n: int,
    tol: float = 1e-10,
    maxiter: int = 1500,
    plan: Optional[chordal_laplacian.ChordalPlan] = None,
) -> torch.Tensor:
    """Solve the anchored rotation least squares, returning (n, d, d) blocks
    (un-projected). Pose 0 is fixed to the identity (reference:
    DPGO_solver.cpp:232-249). With a plan, A goes to the kernel."""
    d = R.shape[-1]
    dtype, dev = R.dtype, R.device
    free = (torch.arange(n, device=dev) > 0).to(dtype)[:, None, None]

    # Rotation connection Laplacian in block form (R R^T = I makes the
    # diagonal blocks scalar): L_ii = deg_i I, L_ij = -kappa_e R_e.
    if plan is not None:
        deg = plan.deg

        def A(Z):
            return chordal_laplacian.chordal_laplacian(Z, plan)
    else:
        deg = torch.zeros((n,), dtype=dtype, device=dev)
        deg.index_add_(0, i, kappa).index_add_(0, j, kappa)
        E = kappa[:, None, None] * R  # (m, d, d)
        m = i.shape[0]

        def A(Z):
            Rf = Z.reshape(n, d * d)
            Ri = Rf[i].reshape(m, d, d)
            Rj = Rf[j].reshape(m, d, d)
            ci = (Rj @ E.transpose(-1, -2)).reshape(m, d * d)  # Rot_j E^T
            cj = (Ri @ E).reshape(m, d * d)  # Rot_i E
            outf = deg[:, None] * Rf
            outf.index_add_(0, i, ci, alpha=-1).index_add_(0, j, cj, alpha=-1)
            return outf.reshape(n, d, d) * free

    # anchoring: Rot = embed(I at pose 0) + Z with Z on the free blocks
    anchor = torch.zeros((n, d, d), dtype=dtype, device=dev)
    anchor[0] = torch.eye(d, dtype=dtype, device=dev)
    b = -A(anchor)

    # Jacobi preconditioner: the diagonal block at pose i is deg_i * I
    tiny = torch.finfo(dtype).tiny
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=tiny), 1.0)

    def M(Z):
        return Z * inv_deg[:, None, None] * free

    Z0 = torch.zeros((n, d, d), dtype=dtype, device=dev)
    return anchor + _pcg(A, b, M, Z0, tol=tol, maxiter=maxiter)


@trace.spanned("chordal.translations")
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
    plan: Optional[chordal_laplacian.ChordalPlan] = None,
) -> torch.Tensor:
    """Solve the anchored translation least squares given rotations,
    returning (n, d). Pose 0 is fixed at the origin (reference:
    DPGO_utils.cpp:435-462). With a plan, A goes to the kernel."""
    dtype, dev = R.dtype, R.device
    d = R.shape[-1]
    free = (torch.arange(n, device=dev) > 0).to(dtype)[:, None]

    c = (Rot[i] @ t[:, :, None])[:, :, 0]  # Rot_i t_e

    if plan is not None:
        def A(z):
            return chordal_laplacian.chordal_laplacian(z, plan)
    else:
        def A(z):
            res = (z[j] - z[i]) * tau[:, None]
            out = torch.zeros_like(z)
            out.index_add_(0, j, res)
            out.index_add_(0, i, -res)
            return out * free

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
    trace.COUNTS["chordal.solves"] += 1

    def tensor(x, dt):
        return torch.as_tensor(x, device=device).to(dt)

    i = tensor(edges.p1, torch.int64)
    j = tensor(edges.p2, torch.int64)
    R = tensor(edges.R, cg_dt)
    t = tensor(edges.t, cg_dt)
    kappa = tensor(edges.kappa, cg_dt)
    tau = tensor(edges.tau, cg_dt)

    plan = None
    if _build.on_card(R):
        with trace.span("chordal.plan"):
            plan = chordal_laplacian.make_plan(i, j, n, kappa, R, tau)
    Rot = _chordal_rotations(i, j, R, kappa, n, tol=tol, maxiter=maxiter,
                             plan=plan)
    with trace.span("chordal.project"):
        Rot = lifted.project_rotation(Rot.to(dtype))
    tv = _recover_translations(
        i, j, R, t, tau, Rot.to(cg_dt), n, tol=tol, maxiter=maxiter,
        plan=plan)
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
