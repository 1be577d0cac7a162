"""Batched lifted-pose manifold operations on tensors.

The variable of the rank-relaxed PGO problem is X in (St(d, r) x R^r)^n,
stored as one tensor of shape (n, r, d+1): X[i] = [Y_i | p_i] with Y_i an
r-by-d Stiefel matrix (Y_i^T Y_i = I_d) and p_i in R^r. The counterpart of
dpgo_tpu/ops/lifted.py (reference: src/manifold/LiftedSEManifold.cpp,
DPGO_utils.cpp:464-499), batched over the leading pose axis.

Where the JAX package passes Precision.HIGHEST (the tangent projection and
the Newton-Schulz polar), the port computes in full float32 whatever the
TF32 setting (devices.highest): the normal component of a tangent
projection's input is O(1) even when the projected result is tiny, and the
Newton-Schulz iteration amplifies rounding.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch.devices import highest

# Lifting matrices Y (r x d) shared by all agents, one per (d, r) in use.
# dpgo_tpu draws them as qf(N(0, 1)) from jax.random.PRNGKey(1)
# (lifted.fixed_stiefel_variable); torch cannot reproduce those bytes, so the
# float64 values are pinned here, and tests/test_torch_lifted.py holds them
# against the JAX function.
_LIFTING = {
    (2, 3): (
        (-0.8121899716552174, -0.22874986759847862),
        (0.11843211910286305, 0.8361169768771852),
        (-0.5712453790688398, 0.4985798823172022),
    ),
    (2, 5): (
        (-0.8106173415927371, -0.1342813138911296),
        (0.11820280094163925, 0.5026949058801791),
        (-0.5701392860517766, 0.30243328472084374),
        (0.05164405233344665, -0.3880235394701974),
        (-0.03466568501596087, -0.6980244991773362),
    ),
    (3, 5): (
        (-0.5658897417991153, 0.08120398439682662, 0.6472058830722389),
        (0.4574326085761011, -0.6600015368111927, 0.35724147673046486),
        (0.03605257122061052, -0.5001826300181249, 0.12098911572269105),
        (-0.6462563124554785, -0.4544205050206211, -0.0758362420147423),
        (0.22710614139125201, 0.31799878234027734, 0.6581136455763871),
    ),
}


def rotations(X: torch.Tensor) -> torch.Tensor:
    """Stiefel blocks Y: (n, r, d)."""
    return X[..., :-1]


def translations(X: torch.Tensor) -> torch.Tensor:
    """Translation vectors p: (n, r)."""
    return X[..., -1]


def assemble(Y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inverse of (rotations, translations)."""
    return torch.cat([Y, p[..., None]], dim=-1)


def identity_lifted(
    n: int, r: int, d: int, dtype=torch.float64, *, device
) -> torch.Tensor:
    """Vertically padded identity initialization (reference:
    Poses.cpp:14-23): (n, r, d+1)."""
    X = torch.zeros((n, r, d + 1), dtype=dtype, device=device)
    X[:, :d, :d] = torch.eye(d, dtype=dtype, device=device)
    return X


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


@highest
def stiefel_proj_tangent(Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection onto the tangent space of St(d, r) at Y:
    P_Y(V) = V - Y sym(Y^T V)."""
    return V - Y @ _sym(Y.transpose(-1, -2) @ V)


def proj_tangent(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Tangent projection on the product manifold (St(d,r) x R^r)^n: Stiefel
    blocks are projected, translation components pass through."""
    Yv = stiefel_proj_tangent(rotations(X), rotations(V))
    return assemble(Yv, translations(V))


def _qf(M: torch.Tensor) -> torch.Tensor:
    """Batched Q-factor with positive diagonal R (the "qf" retraction of
    ROPTLIB's ChooseStieParamsSet3; reference: LiftedSEManifold.cpp:19) of
    (..., r, d) matrices of full column rank.

    Modified Gram-Schmidt over the d <= 3 columns gives exactly that factor
    (each R_kk is a norm, so positive) in a few elementwise ops over the
    batch. The JAX package takes a Householder QR and flips signs; on the
    card torch.linalg.qr runs its Householder product matrix by matrix and
    took 3.4 s for 100,000 5x2 float64 blocks (H100, PERF.md)."""
    cols = []
    for k in range(M.shape[-1]):
        v = M[..., k]
        for q in cols:
            v = v - (q * v).sum(dim=-1, keepdim=True) * q
        cols.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    return torch.stack(cols, dim=-1)


def retract(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """QR retraction on the product manifold: qf(Y + V_Y) for each Stiefel
    block, p + V_p for translations."""
    Y = _qf(rotations(X) + rotations(V))
    p = translations(X) + translations(V)
    return assemble(Y, p)


def project_rotation(M: torch.Tensor) -> torch.Tensor:
    """Batched projection onto SO(d): SVD with determinant fix
    (reference: DPGO_utils.cpp:464-478)."""
    U, _, Vh = torch.linalg.svd(M, full_matrices=False)
    det = torch.linalg.det(U) * torch.linalg.det(Vh)
    d = M.shape[-1]
    ones = torch.ones(d, dtype=M.dtype, device=M.device)
    last = ones.clone()
    last[-1] = -1.0
    flip = torch.where(det[..., None] > 0, ones, last)
    return (U * flip[..., None, :]) @ Vh


def project_stiefel(M: torch.Tensor) -> torch.Tensor:
    """Batched projection onto St(d, r) via thin SVD: U V^T
    (reference: DPGO_utils.cpp:480-486)."""
    U, _, Vh = torch.linalg.svd(M, full_matrices=False)
    return U @ Vh


def project_lifted(X: torch.Tensor) -> torch.Tensor:
    """Project an arbitrary (..., r, d+1) tensor onto the lifted-pose
    manifold: each Stiefel block via SVD, translations unchanged
    (reference: LiftedSEManifold.cpp:34-45)."""
    return assemble(project_stiefel(rotations(X)), translations(X))


def _ns_step(Y: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz polar step Y <- 1.5 Y - 0.5 Y (Y^T Y)."""
    return 1.5 * Y - 0.5 * (Y @ (Y.transpose(-1, -2) @ Y))


@highest
def project_stiefel_ns(M: torch.Tensor, num_iters: int = 16) -> torch.Tensor:
    """SVD-free Stiefel projection by the Newton-Schulz polar iteration,
    which converges quadratically to U V^T for 0 < sigma < sqrt(3). Blocks
    are pre-scaled by 1/||M||_F (a bound on sigma_max); the default 16
    iterations cover sigma_min down to ~0.1."""
    s = torch.sqrt((M * M).sum(dim=(-2, -1), keepdim=True))
    Y = M / torch.clamp(s, min=torch.finfo(M.dtype).tiny)
    for _ in range(num_iters):
        Y = _ns_step(Y)
    return Y


def project_lifted_ns(X: torch.Tensor, num_iters: int = 16) -> torch.Tensor:
    """project_lifted with the Newton-Schulz polar instead of SVD."""
    return assemble(project_stiefel_ns(rotations(X), num_iters), translations(X))


@highest
def project_stiefel_ns_mixed(
    M: torch.Tensor, num_iters: int = 16, refine_iters: int = 2
) -> torch.Tensor:
    """Newton-Schulz polar with the bulk of the iteration in float32 and
    `refine_iters` polishing steps in the input dtype: its fixed points are
    exactly the orthonormal matrices, so the polish takes the float32
    result's ~3e-7 orthonormality to the input precision."""
    if M.dtype == torch.float32:
        return project_stiefel_ns(M, num_iters)
    Y = project_stiefel_ns(M.to(torch.float32), num_iters).to(M.dtype)
    for _ in range(refine_iters):
        Y = _ns_step(Y)
    return Y


def project_lifted_ns_mixed(
    X: torch.Tensor, num_iters: int = 16, refine_iters: int = 2
) -> torch.Tensor:
    """project_lifted with the mixed-precision Newton-Schulz polar."""
    return assemble(
        project_stiefel_ns_mixed(rotations(X), num_iters, refine_iters),
        translations(X),
    )


def fixed_stiefel_variable(
    d: int, r: int, *, device, dtype=torch.float64
) -> torch.Tensor:
    """Deterministic r x d Stiefel point shared by all agents as the lifting
    matrix: the same values as dpgo_tpu's fixed_stiefel_variable(d, r).
    Only the pinned (d, r) pairs exist."""
    try:
        Y = _LIFTING[(d, r)]
    except KeyError:
        raise ValueError(
            f"no pinned lifting matrix for (d, r) = ({d}, {r}); "
            f"pinned: {sorted(_LIFTING)}"
        ) from None
    return torch.tensor(Y, dtype=torch.float64, device=device).to(dtype)


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean (Frobenius) inner product over the full product variable."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(inner(a, a))


def max_translation_distance(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """max_i ||p1_i - p2_i|| over every pose (reference: Poses.cpp:86-94),
    the relative-change metric of local termination (PGOAgent.cpp:406)."""
    diff = translations(X1) - translations(X2)
    return torch.linalg.vector_norm(diff, dim=-1).max()
