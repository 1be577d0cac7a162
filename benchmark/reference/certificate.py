"""Plain reference of the dual certificate of a centralized solve.

SE-Sync (Rosen et al., IJRR 2019, Algorithm 1 and its minimum-eigenvalue
verification): at a first-order critical point X = [Y_i p_i] (n, r, d+1)
of the lifted pose-graph objective f(X) = 1/2 <X Q, X>, the multipliers of
the constraints Y_i^T Y_i = I are Lambda_i = sym(Y_i^T (X Q)_i^rot), and
S = Q - LambdaHat (LambdaHat block diagonal, [Lambda_i, 0] on pose i's
block) satisfies X S = 0. X is a global minimizer of the relaxation when
S >= 0; the program certifies lambda_min(S) >= -eta.

This file recomputes, in float64 from the raw edges and the returned X
alone, what that verdict rests on:

  (i)   the stationarity ||X S||_F;
  (ii)  the Rayleigh quotient theta and the residual of the program's
        eigenvector under P S P, where P projects out its own deflation
        basis (X's rows and the translation-gauge vector: S annihilates
        them at a critical point);
  (iii) its own Lanczos with full reorthogonalization on P S P, K steps
        from its own seeded start. Its smallest Ritz value rho bounds the
        deflated operator's lambda_min from above, so rho < -eta refutes a
        "certified".

W -> W S is written edge by edge, as objective.py writes the gradient:
W Q is the gradient of 1/2 <W Q, W>. It imports nothing of the program
and takes from it only the answer being judged. Plain torch: on the card
when X is there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# edges per block, as objective.py
BLOCK = 1 << 20
# Lanczos steps of (iii) and the seed of its start
K = 64
SEED = 20190101
# singular values of [rows of X; gauge] above this share of the largest
# span the deflation basis. The program's rule: the iterate is a rank-d
# point (its solve keeps rank d exactly, the other singular values are
# rounding), so any cut between 1e-12 and 1e-3 gives the same span
DEFLATION_CUT = 1e-6

# Each compared number is a gap relative to its scale, set between two
# readings on the 10k grid (an H100, 700 W) and the 216-pose grid (CPU): the
# program in float64, and its certificate's S-action in float32 (the whole
# certificate, or the whole program, in float32 reads alike). Any one of
# them fails the float32 S-action.
LIMITS = {
    # |program - reference| / ||X Q||_F: ||X S|| is a difference of terms
    # of size ||X Q||, so two float64 summation orders leave ~1e-15 of that
    # (read: 1e-16 to 5.3e-14), float32's ~1e-5 (6.2e-6 to 1.4e-4)
    "stationarity_gap": 1e-10,
    # |program's Ritz value - theta| / ||P S P||, ||P S P|| read as the
    # largest |Ritz value| of (iii): the program's value is the Rayleigh
    # quotient of its vector, in float64 equal to the reference's to the
    # last digits (read: 0 to 8.5e-19; a Ritz value of float64 Lanczos
    # with full reorthogonalization, unrefined, would lie ~1e-16 off),
    # in float32 1.4e-12 to 1.6e-11
    "ritz_gap": 1e-14,
    # |program's residual - reference's| / ||P S P||: the same arithmetic
    # on the same vector (read: 2e-23 to 6e-19; float32 1.2e-12 to 1.3e-11)
    "residual_gap": 1e-14,
}


class Graph(NamedTuple):
    """The edge columns on X's device, float64."""

    i: torch.Tensor
    j: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    wk: torch.Tensor
    wt: torch.Tensor


def graph(edges, device) -> Graph:
    """The benchmark Edges tuple's columns as tensors."""
    def col(a, dt=torch.float64):
        return torch.as_tensor(a, device=device).to(dt)

    return Graph(col(edges.p1, torch.int64), col(edges.p2, torch.int64),
                 col(edges.R), col(edges.t),
                 col(edges.weight * edges.kappa),
                 col(edges.weight * edges.tau))


def q_action(g: Graph, W: torch.Tensor) -> torch.Tensor:
    """W Q for W (n, c, d+1): each of its c rows is a lifted iterate, and
    W Q is the Euclidean gradient of 1/2 sum_k wk |W_i R - W_j|^2 +
    wt |W_i t + w_i - w_j|^2 over the rotation columns W and the
    translation column w."""
    d = W.shape[-1] - 1
    WY, wp = W[..., :d], W[..., d]
    gY = torch.zeros_like(WY)
    gp = torch.zeros_like(wp)
    for lo in range(0, g.i.shape[0], BLOCK):
        s = slice(lo, lo + BLOCK)
        i, j, R, t = g.i[s], g.j[s], g.R[s], g.t[s]
        Yi = WY[i]
        rot = Yi @ R - WY[j]                              # (m, c, d)
        tr = (Yi @ t[:, :, None])[..., 0] + wp[i] - wp[j]  # (m, c)
        wrot = g.wk[s, None, None] * rot
        wtr = g.wt[s, None] * tr
        gY.index_add_(0, i, wrot @ R.transpose(1, 2)
                      + wtr[:, :, None] * t[:, None, :])
        gY.index_add_(0, j, -wrot)
        gp.index_add_(0, i, wtr)
        gp.index_add_(0, j, -wtr)
    return torch.cat([gY, gp[..., None]], dim=-1)


def multipliers(g: Graph, X: torch.Tensor) -> torch.Tensor:
    """Lambda_i = sym(Y_i^T (X Q)_i^rot): (n, d, d)."""
    d = X.shape[-1] - 1
    YtG = X[..., :d].transpose(1, 2) @ q_action(g, X)[..., :d]
    return 0.5 * (YtG + YtG.transpose(1, 2))


def s_action(g: Graph, Lam: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """W S = W Q - [W_i^rot Lambda_i, 0] for W (n, c, d+1)."""
    d = W.shape[-1] - 1
    WQ = q_action(g, W)
    return torch.cat([WQ[..., :d] - W[..., :d] @ Lam, WQ[..., d:]], dim=-1)


def deflation_basis(X: torch.Tensor) -> torch.Tensor:
    """Orthonormal rows (q, n (d+1)) spanning X's r rows and the gauge
    vector (1 on every translation entry)."""
    n, r, dh = X.shape
    gauge = torch.zeros((1, n, dh), dtype=X.dtype, device=X.device)
    gauge[..., dh - 1] = 1.0
    M = torch.cat([X.transpose(0, 1), gauge]).reshape(r + 1, n * dh)
    _u, sv, Vh = torch.linalg.svd(M, full_matrices=False)
    return Vh[sv > DEFLATION_CUT * sv[0]]


def lanczos(op, v0: torch.Tensor, k: int) -> torch.Tensor:
    """The Ritz values of k steps of Lanczos on the symmetric op from v0,
    every new vector orthogonalized against all before it, twice; stops at
    an invariant subspace."""
    m = v0.shape[0]
    V = torch.zeros((k, m), dtype=v0.dtype, device=v0.device)
    alpha, beta = [], []
    v = v0 / torch.linalg.vector_norm(v0)
    for s in range(k):
        V[s] = v
        w = op(v)
        a = float(v @ w)
        w = w - a * v
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        b = float(torch.linalg.vector_norm(w))
        alpha.append(a)
        if b < 1e-10 * max(abs(x) for x in alpha):
            break
        beta.append(b)
        v = w / b
    n = len(alpha)
    T = torch.diag(torch.tensor(alpha, dtype=torch.float64))
    off = torch.tensor(beta[:n - 1], dtype=torch.float64)
    T += torch.diag(off, 1) + torch.diag(off, -1)
    return torch.linalg.eigvalsh(T)


def readings(edges, X: torch.Tensor, eigvec, ritz: float, residual: float,
             stationarity: float) -> dict:
    """The reference's readings of the certificate the program gave for X:
    eigvec (n, d+1) and its deflated Ritz value `ritz` with its residual,
    and the program's stationarity. Returns rho, theta, the reference's
    residual and stationarity, and the three gaps of LIMITS."""
    X = X.to(torch.float64)
    dev = X.device
    n, r, dh = X.shape
    m = n * dh
    g = graph(edges, dev)
    Lam = multipliers(g, X)
    B = deflation_basis(X)

    def defl(w):
        return w - B.T @ (B @ w)

    def op(w):
        return defl(s_action(g, Lam, defl(w).reshape(n, 1, dh)).reshape(m))

    # (i)
    stat = float(torch.linalg.vector_norm(s_action(g, Lam, X)))
    scale_xq = float(torch.linalg.vector_norm(q_action(g, X)))
    # (iii)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    v0 = defl(torch.randn((m,), generator=gen, dtype=torch.float64).to(dev))
    ritz_values = lanczos(op, v0, min(K, m - B.shape[0]))
    rho = float(ritz_values[0])
    scale_s = float(ritz_values.abs().max())
    # (ii)
    v = torch.as_tensor(eigvec, dtype=torch.float64).to(dev).reshape(m)
    v = v / torch.linalg.vector_norm(v)
    Sv = op(v)
    theta = float(v @ Sv)
    res = float(torch.linalg.vector_norm(Sv - theta * v))
    return {"rho": rho, "theta": theta, "residual": res,
            "stationarity": stat,
            "stationarity_gap": abs(stationarity - stat) / scale_xq,
            "ritz_gap": abs(ritz - theta) / scale_s,
            "residual_gap": abs(residual - res) / scale_s}


def agrees(reading: dict, eta: float) -> bool:
    """rho >= -eta, and every gap within its limit."""
    return reading["rho"] >= -eta and all(
        reading[name] <= limit for name, limit in LIMITS.items())
