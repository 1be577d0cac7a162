"""Plain reference of what a solve must deliver, written from the raw edges.

The lifted pose-graph objective over X = [Y_i p_i] (n, r, d+1), Y_i on the
Stiefel manifold St(d, r), for edges k = (i -> j, R, t, kappa, tau, w):

    f(X) = 1/2 sum_k w (kappa |Y_i R - Y_j|^2 + tau |Y_i t + p_i - p_j|^2)

its Euclidean gradient edge by edge, the Riemannian gradient (the Stiefel
blocks projected onto the tangent space, V - Y sym(Y^T V); translations
unchanged) and its norm, and how far each Y_i is from orthonormal. All in
float64 from the edge arrays the benchmark generated; it imports nothing
of the program and takes nothing the program made but the iterate X that
is being judged. Plain torch: on the card when X is there.
"""

from __future__ import annotations

import torch

# edges per block: bounds the reference's own memory on the largest graph
BLOCK = 1 << 20


def readings(edges, X: torch.Tensor) -> dict:
    """{"cost", "gradnorm", "orthonormality"} of the iterate X on `edges`
    (a benchmark Edges tuple): f(X), the Riemannian gradient norm, and the
    largest entry of |Y_i^T Y_i - I| over the poses."""
    X = X.to(torch.float64)
    dev = X.device
    n, r, dh = X.shape
    d = dh - 1
    Y, p = X[..., :d], X[..., d]
    gY = torch.zeros_like(Y)
    gp = torch.zeros_like(p)
    f = torch.zeros((), dtype=torch.float64, device=dev)

    def col(a, dt=torch.float64):
        return torch.as_tensor(a, device=dev).to(dt)

    for lo in range(0, edges.m, BLOCK):
        s = slice(lo, lo + BLOCK)
        i, j = col(edges.p1[s], torch.int64), col(edges.p2[s], torch.int64)
        R, t = col(edges.R[s]), col(edges.t[s])
        wk = col(edges.weight[s] * edges.kappa[s])
        wt = col(edges.weight[s] * edges.tau[s])
        Yi = Y[i]
        rot = Yi @ R - Y[j]                               # (m, r, d)
        tr = (Yi @ t[:, :, None])[..., 0] + p[i] - p[j]   # (m, r)
        f = f + 0.5 * (wk * rot.square().sum((1, 2))
                       + wt * tr.square().sum(1)).sum()
        wrot = wk[:, None, None] * rot
        wtr = wt[:, None] * tr
        gY.index_add_(0, i, wrot @ R.transpose(1, 2)
                      + wtr[:, :, None] * t[:, None, :])
        gY.index_add_(0, j, -wrot)
        gp.index_add_(0, i, wtr)
        gp.index_add_(0, j, -wtr)
    YtG = Y.transpose(1, 2) @ gY
    rgY = gY - Y @ (0.5 * (YtG + YtG.transpose(1, 2)))
    gradnorm = torch.sqrt(rgY.square().sum() + gp.square().sum())
    eye = torch.eye(d, dtype=torch.float64, device=dev)
    orth = (Y.transpose(1, 2) @ Y - eye).abs().amax()
    return {"cost": float(f), "gradnorm": float(gradnorm),
            "orthonormality": float(orth)}
