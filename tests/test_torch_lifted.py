"""Parity of dpgo_tpu_torch.ops.lifted with dpgo_tpu.ops.lifted (float64,
CPU). Deterministic pieces agree to 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.ops import lifted as jl
from dpgo_tpu_torch.ops import lifted as tl

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _stiefel_and_tangent(rng, n, r, d):
    Y = np.linalg.qr(rng.standard_normal((n, r, d)))[0]
    X = np.concatenate([Y, rng.standard_normal((n, r, 1))], axis=-1)
    V = rng.standard_normal((n, r, d + 1))
    return X, V


@pytest.mark.parametrize("d,r", [(2, 3), (2, 5), (3, 5)])
def test_lifting_matrix_pinned_to_jax(d, r):
    ref = np.asarray(jl.fixed_stiefel_variable(d, r))
    got = tl.fixed_stiefel_variable(d, r, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got.T @ got, np.eye(d), atol=1e-14)


def test_lifting_matrix_unpinned_pair_raises():
    with pytest.raises(ValueError, match="no pinned lifting matrix"):
        tl.fixed_stiefel_variable(3, 4, device="cpu")


@pytest.mark.parametrize("d,r", [(2, 2), (2, 5), (3, 3), (3, 5)])
def test_qf_matches_jax(d, r):
    rng = np.random.default_rng(10 * d + r)
    M = rng.standard_normal((64, r, d))
    ref = np.asarray(jl._qf(jnp.asarray(M)))
    got = tl._qf(_t(M)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL)
    # positive-diagonal R: Q^T M is upper triangular with diagonal > 0
    R = np.swapaxes(got, -1, -2) @ M
    assert np.all(np.diagonal(R, axis1=-2, axis2=-1) > 0)


@pytest.mark.parametrize("d,r", [(2, 5), (3, 5)])
def test_retract_and_projections_match_jax(d, r):
    rng = np.random.default_rng(d + r)
    X, V = _stiefel_and_tangent(rng, 50, r, d)
    jX, jV, tX, tV = jnp.asarray(X), jnp.asarray(V), _t(X), _t(V)
    pairs = [
        (jl.proj_tangent(jX, jV), tl.proj_tangent(tX, tV)),
        (jl.stiefel_proj_tangent(jl.rotations(jX), jl.rotations(jV)),
         tl.stiefel_proj_tangent(tl.rotations(tX), tl.rotations(tV))),
        (jl.retract(jX, 0.3 * jl.proj_tangent(jX, jV)),
         tl.retract(tX, 0.3 * tl.proj_tangent(tX, tV))),
        (jl.assemble(jl.rotations(jX), jl.translations(jV)),
         tl.assemble(tl.rotations(tX), tl.translations(tV))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(float(tl.inner(tX, tV)),
                               float(jl.inner(jX, jV)), rtol=RTOL)
    np.testing.assert_allclose(float(tl.norm(tV)), float(jl.norm(jV)),
                               rtol=RTOL)


@pytest.mark.parametrize("d", [2, 3])
def test_project_rotation_matches_jax(d):
    rng = np.random.default_rng(d)
    M = rng.standard_normal((200, d, d))  # about half have det < 0
    ref = np.asarray(jl.project_rotation(jnp.asarray(M)))
    got = tl.project_rotation(_t(M)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-12)


def _near_stiefel(rng, shape, noise):
    """Orthonormal-column blocks plus noise, as the Nesterov combinations
    (1 - a) X + a V the projections take."""
    Q = np.linalg.qr(rng.standard_normal(shape))[0]
    return Q + noise * rng.standard_normal(shape)


@pytest.mark.parametrize("d,r", [(2, 3), (3, 5)])
def test_polar_projections_match_jax(d, r):
    """The SVD polar and the float64 Newton-Schulz polar within 1e-12, on
    lifted (n, r, d+1) iterates and on a batch of agents' blocks."""
    rng = np.random.default_rng(d * r)
    M = _near_stiefel(rng, (4, 30, r, d), 0.3)
    X = np.concatenate([M, rng.standard_normal((4, 30, r, 1))], axis=-1)
    for tf, jf in ((tl.project_stiefel, jl.project_stiefel),
                   (tl.project_stiefel_ns, jl.project_stiefel_ns)):
        np.testing.assert_allclose(tf(_t(M)).numpy(), np.asarray(jf(jnp.asarray(M))),
                                   rtol=0, atol=RTOL)
    for tf, jf in ((tl.project_lifted, jl.project_lifted),
                   (tl.project_lifted_ns, jl.project_lifted_ns)):
        got = tf(_t(X)).numpy()
        np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(X))),
                                   rtol=0, atol=RTOL)
        np.testing.assert_array_equal(got[..., -1], X[..., -1])
    Y = tl.project_stiefel(_t(M)).numpy()
    YtY = np.swapaxes(Y, -1, -2) @ Y
    np.testing.assert_allclose(YtY, np.broadcast_to(np.eye(d), YtY.shape),
                               atol=1e-14)


def test_mixed_newton_schulz_matches_jax():
    """The float32 bulk with a float64 polish: orthonormal to 1e-13 in both
    packages, and within 1e-6 of each other and of the SVD polar (the
    float32 bulks round differently; the polish keeps that difference)."""
    rng = np.random.default_rng(7)
    M = _near_stiefel(rng, (200, 5, 3), 0.3)
    got = tl.project_stiefel_ns_mixed(_t(M)).numpy()
    ref = np.asarray(jl.project_stiefel_ns_mixed(jnp.asarray(M)))
    for Y in (got, ref):
        YtY = np.swapaxes(Y, -1, -2) @ Y
        np.testing.assert_allclose(YtY, np.broadcast_to(np.eye(3), YtY.shape),
                                   atol=1e-13)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, tl.project_stiefel(_t(M)).numpy(), rtol=0,
                               atol=1e-6)
    X = np.concatenate([M, rng.standard_normal((200, 5, 1))], axis=-1)
    lifted_got = tl.project_lifted_ns_mixed(_t(X)).numpy()
    np.testing.assert_allclose(lifted_got[..., :3], got, rtol=0, atol=0)
    np.testing.assert_array_equal(lifted_got[..., -1], X[..., -1])
    # float32 input: the float32 chain alone, in both packages
    M32 = M.astype(np.float32)
    np.testing.assert_allclose(
        tl.project_stiefel_ns_mixed(_t(M32)).numpy(),
        np.asarray(jl.project_stiefel_ns_mixed(jnp.asarray(M32))), atol=2e-6)


def test_identity_and_translation_distance_match_jax():
    np.testing.assert_array_equal(
        tl.identity_lifted(7, 5, 3, device="cpu").numpy(),
        np.asarray(jl.identity_lifted(7, 5, 3)))
    rng = np.random.default_rng(8)
    X1, X2 = rng.standard_normal((2, 3, 40, 5, 4))
    np.testing.assert_allclose(
        float(tl.max_translation_distance(_t(X1), _t(X2))),
        max(float(jl.max_translation_distance(jnp.asarray(a), jnp.asarray(b)))
            for a, b in zip(X1, X2)), rtol=RTOL)


def test_projections_ignore_tf32():
    """Where the JAX package passes Precision.HIGHEST, the port's float32
    products stay full float32 with TF32 switched on (the flag only acts on
    the card; it is restored afterwards)."""
    rng = np.random.default_rng(9)
    M = _t(_near_stiefel(rng, (50, 5, 3), 0.3).astype(np.float32))
    ref = tl.project_stiefel_ns(M)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        seen = []
        orig = tl._ns_step

        def spy(Y):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return orig(Y)

        tl._ns_step = spy
        got = tl.project_stiefel_ns(M)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        tl._ns_step = orig
        torch.backends.cuda.matmul.allow_tf32 = before
    assert seen and not any(seen)
    assert torch.equal(got, ref)
