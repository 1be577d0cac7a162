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


def _odometry(name, n):
    """The chain edges k -> k+1 of a synthetic graph, shuffled, as the
    EdgeArrays of both packages (the port reads the JAX package's, plain
    numpy fields)."""
    edges, _ = (jd.synthesize_city2d(n, seed=2) if name == "city"
                else jd.synthesize_grid3d(n, seed=2))[:2]
    chain = np.nonzero(edges.p2 - edges.p1 == 1)[0]
    chain = np.random.default_rng(0).permutation(chain)
    return type(edges)(**{k: v[chain] for k, v in vars(edges).items()})


def _numpy_chain(odo, n):
    """Dead reckoning by a sequential float64 loop."""
    d = odo.t.shape[1]
    order = np.argsort(odo.p1)
    T = np.zeros((n, d, d + 1))
    T[0, :, :d] = np.eye(d)
    for k, e in enumerate(order[: n - 1]):
        R, t = T[k, :, :d], T[k, :, d]
        T[k + 1, :, :d] = R @ odo.R[e]
        T[k + 1, :, d] = R @ odo.t[e] + t
    return T


@pytest.mark.parametrize("name,n", [("city", 1000), ("grid", 343)])
def test_odometry_initialization_matches_jax_and_a_loop(name, n):
    """The doubling scan brackets the prefix product differently from the
    JAX package's associative_scan and from a sequential loop, so the three
    agree to rounding: 1e-10 relative to the trajectory's extent on a
    1,000-pose chain in float64."""
    odo = _odometry(name, n)
    got = tc.odometry_initialization_arrays(odo, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (n, odo.t.shape[1],
                                                       odo.t.shape[1] + 1)
    ref = np.asarray(jc.odometry_initialization_arrays(odo))
    loop = _numpy_chain(odo, n)
    scale = np.abs(loop).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got.numpy(), loop, rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("k", [1, 40, 120, 200])
def test_odometry_partial_trajectory_matches_jax(k):
    """A preserved prefix of k poses (any poses, not the chain's own) is
    kept bit for bit and the rest composes odometry from pose k-1; a prefix
    as long as the chain (or longer) is returned as it is."""
    n = 120
    odo = _odometry("grid", 125)
    odo = type(odo)(**{f: v[odo.p1 < n - 1] for f, v in vars(odo).items()})
    rng = np.random.default_rng(k)
    R = np.linalg.qr(rng.standard_normal((k, 3, 3)))[0]
    prefix = np.concatenate([R, rng.standard_normal((k, 3, 1))], axis=-1)
    ref = np.asarray(jc.odometry_initialization_arrays(
        odo, n=n, partial_trajectory=prefix))
    for given in (prefix, torch.as_tensor(prefix)):
        got = tc.odometry_initialization_arrays(
            odo, n=n, partial_trajectory=given, device="cpu")
        assert got.shape == ref.shape == (n, 3, 4)
        np.testing.assert_array_equal(got.numpy()[: min(k, n)], prefix[:n])
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


def test_odometry_initialization_from_measurements():
    """solvers.pgo.odometry_initialization on a measurement list, against
    the JAX package's; empty odometry raises."""
    from dpgo_tpu.solvers import pgo as jpgo
    from dpgo_tpu_torch.solvers import pgo as tpgo

    odo = _odometry("city", 200)
    meas = odo.to_measurements()
    ref = np.asarray(jpgo.odometry_initialization(meas))
    got = tpgo.odometry_initialization(meas, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    empty = type(odo)(**{k: v[:0] for k, v in vars(odo).items()})
    with pytest.raises(ValueError):
        tc.odometry_initialization_arrays(empty, device="cpu")
