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
