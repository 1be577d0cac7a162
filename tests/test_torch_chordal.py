"""Parity of dpgo_tpu_torch.solvers.chordal with dpgo_tpu.solvers.chordal:
float64 chordal initializations agree to 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu.solvers import chordal as jc
from dpgo_tpu_torch.solvers import chordal as tc


def _graph(name):
    if name == "city600":
        return jd.synthesize_city2d(600, seed=0)[:2]
    return jd.synthesize_grid3d(125, seed=0)[:2]


@pytest.mark.parametrize("name", ["city600", "grid125"])
def test_chordal_matches_jax(name):
    edges, n = _graph(name)
    ref = np.asarray(jc.chordal_initialization_arrays(edges, n=n))
    got = tc.chordal_initialization_arrays(edges, n=n, device="cpu")
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8)
    R = got.numpy()[:, :, :-1]
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)


def test_chordal_float32_cg_matches_jax():
    """The slice's settings: float32 CG stages at tol 1e-6, float64 result."""
    edges, n = _graph("city600")
    ref = np.asarray(jc.chordal_initialization_arrays(
        edges, n=n, cg_dtype=jnp.float32, tol=1e-6, maxiter=1000))
    got = tc.chordal_initialization_arrays(
        edges, n=n, cg_dtype=torch.float32, tol=1e-6, maxiter=1000,
        device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


def test_pcg_solves_spd_system():
    rng = np.random.default_rng(0)
    B = rng.standard_normal((20, 20))
    A = torch.as_tensor(B @ B.T + 20 * np.eye(20))
    b = torch.as_tensor(rng.standard_normal(20))
    d = torch.diagonal(A)
    x = tc._pcg(lambda v: A @ v, b, lambda v: v / d, torch.zeros(20, dtype=torch.float64),
                tol=1e-12, maxiter=200)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A.numpy(), b.numpy()),
                               rtol=1e-9)


def test_chordal_rejects_empty_graph():
    edges, n = _graph("city600")
    empty = type(edges)(**{k: v[:0] for k, v in vars(edges).items()})
    with pytest.raises(ValueError):
        tc.chordal_initialization_arrays(empty, n=n, device="cpu")
