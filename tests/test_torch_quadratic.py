"""Parity of dpgo_tpu_torch.quadratic with dpgo_tpu.quadratic.

Both packages get the identical problem (dpgo_tpu_torch.convert carries the
JAX LocalProblem over, band ordering included). Float64 results agree to
1e-12 relative; the float32 CSR matvec agrees with the JAX float32 matvec to
float32 rounding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu import quadratic as jq
from dpgo_tpu_torch import convert
from dpgo_tpu_torch import datasets as td
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.ops import segsum

RTOL = 1e-12


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), jax.Array)}


def _meta(obj):
    return {"n": obj.n, "d": obj.d, "num_band": getattr(obj, "num_band", 0),
            "band_offsets": obj.band_offsets}


def _close(got, ref, rtol=RTOL):
    got, ref = got.numpy(), np.asarray(ref)
    scale = np.abs(ref).max(initial=1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _graph(name):
    if name == "city600":
        return jd.synthesize_city2d(600, seed=0)[:2] + (2,)
    return jd.synthesize_grid3d(125, seed=0)[:2] + (3,)


def _problems(name, band=True):
    edges, n, d = _graph(name)
    jp = jq.from_private_measurements(edges, n=n, d=d, band=band)
    tp = convert.local_problem_from_numpy(_fields(jp), _meta(jp), device="cpu")
    return jp, tp, n, d


def _data(name, r, band=True):
    jp, tp, n, d = _problems(name, band)
    jqd = jq.build_quadratic_data(jp, jnp.zeros((1, r, d + 1)), r=r)
    tqd = tq.build_quadratic_data(
        tp, torch.zeros((1, r, d + 1), dtype=torch.float64), r=r
    )
    return jqd, tqd, n, d


def _lifted_point(n, r, d, seed):
    rng = np.random.default_rng(seed)
    Y = np.linalg.qr(rng.standard_normal((n, r, d)))[0]
    X = np.concatenate([Y, rng.standard_normal((n, r, 1))], axis=-1)
    V = rng.standard_normal((n, r, d + 1))
    return X, V


@pytest.mark.parametrize("name", ["city600", "grid125"])
def test_band_planning_matches_jax(name):
    edges, n, d = _graph(name)
    jp = jq.from_private_measurements(edges, n=n, d=d)
    tedges = (td.synthesize_city2d(600, seed=0) if name == "city600"
              else td.synthesize_grid3d(125, seed=0))[0]
    tp = tq.from_private_measurements(tedges, n=n, d=d, device="cpu")
    assert tp.band_offsets == jp.band_offsets and tp.num_band == jp.num_band
    for k in ("priv_i", "priv_j", "priv_lane"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)))
    for k in ("priv_T", "priv_kappa", "priv_tau", "priv_weight"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)))
    # a forced lane set, negative offsets included
    jf = jq.plan_bands(jp, offsets=(-12, 1, 7))
    tf = tq.plan_bands(tp, offsets=(-12, 1, 7))
    assert tf.num_band == jf.num_band and tf.band_offsets == (-12, 1, 7)
    for k in ("priv_i", "priv_j", "priv_lane"):
        np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                      np.asarray(getattr(jf, k)))
    rng = np.random.default_rng(3)
    i = rng.integers(0, 400, 3000)
    j = np.where(rng.random(3000) < 0.5, i + 7, rng.integers(0, 400, 3000))
    for kw in ({}, {"max_lanes": 2}, {"min_count": 5}):
        assert (tq.choose_band_offsets(i, j, 420, **kw)
                == jq.choose_band_offsets(i, j, 420, **kw))


@pytest.mark.parametrize("name,band", [("city600", True), ("city600", False),
                                       ("grid125", True)])
def test_assembly_matches_jax(name, band):
    jqd, tqd, n, d = _data(name, r=5, band=band)
    assert tqd.band_offsets == jqd.band_offsets
    for k in ("diag", "off_E", "G", "precond_inv"):
        _close(getattr(tqd, k), getattr(jqd, k))
    for k in ("off_i", "off_j"):
        np.testing.assert_array_equal(getattr(tqd, k).numpy(),
                                      np.asarray(getattr(jqd, k)))
    assert (tqd.band_E is None) == (jqd.band_E is None) == (not band)
    if band:
        _close(tqd.band_E, jqd.band_E)


def test_assembly_with_shared_edges_and_priors():
    """Shared-edge diagonal blocks, the linear term G and priors."""
    rng = np.random.default_rng(11)
    n, d, r, ms, npr, p = 30, 3, 5, 12, 3, 6
    edges, _, _ = jd.synthesize_grid3d(n, seed=2)
    from dpgo_tpu.measurements import homogeneous

    T = homogeneous(edges.R, edges.t)
    sT = T[:ms]
    kw = dict(
        shared_idx=rng.integers(0, n, ms), shared_T=sT,
        shared_kappa=rng.uniform(1, 100, ms), shared_tau=rng.uniform(1, 10, ms),
        shared_weight=rng.uniform(0, 1, ms),
        shared_outgoing=rng.random(ms) < 0.5,
        shared_nbr_slot=rng.integers(0, p, ms),
        shared_mask=(rng.random(ms) < 0.8).astype(float),
        prior_idx=rng.integers(0, n, npr),
        prior_pose=rng.standard_normal((npr, r, d + 1)),
        prior_mask=np.ones(npr), r=r,
    )
    jp = jq.make_local_problem(
        n, d, edges.p1, edges.p2, T, edges.kappa, edges.tau, edges.weight, **kw
    )
    jp = jq.plan_bands(jp)
    tp = convert.local_problem_from_numpy(_fields(jp), _meta(jp), device="cpu")
    nbr = rng.standard_normal((p, r, d + 1))
    jqd = jq.build_quadratic_data(jp, jnp.asarray(nbr), r=r, precond_shift=0.5)
    tqd = tq.build_quadratic_data(tp, torch.as_tensor(nbr), r=r,
                                  precond_shift=0.5)
    for k in ("diag", "G", "precond_inv"):
        _close(getattr(tqd, k), getattr(jqd, k))
    # the port's own constructor builds the same problem
    tp2 = tq.plan_bands(tq.make_local_problem(
        n, d, edges.p1, edges.p2, T, edges.kappa, edges.tau, edges.weight,
        device="cpu", **kw))
    _close(tq.build_quadratic_data(tp2, torch.as_tensor(nbr), r=r,
                                   precond_shift=0.5).precond_inv,
           jqd.precond_inv)


@pytest.mark.parametrize("name,band", [("city600", True), ("city600", False),
                                       ("grid125", True)])
def test_operators_match_jax(name, band):
    """q_matvec on the band-only (grid125: every edge on a lane), band +
    gather (city600) and gather-only (band=False) paths, and the operators
    built on it."""
    r = 5
    jqd, tqd, n, d = _data(name, r=r, band=band)
    if name == "grid125":
        assert tqd.off_E.shape[0] == 0 and tqd.band_E is not None
    X, V = _lifted_point(n, r, d, seed=5)
    jX, jV, tX, tV = jnp.asarray(X), jnp.asarray(V), torch.as_tensor(X), torch.as_tensor(V)
    _close(tq.q_matvec(tqd, tV), jq.q_matvec(jqd, jV))
    eg = jq.euc_grad(jqd, jX)
    _close(tq.euc_grad(tqd, tX), eg)
    _close(tq.rie_grad(tqd, tX), jq.rie_grad(jqd, jX))
    S = jq.hess_correction(jX, eg)
    tS = tq.hess_correction(tX, tq.euc_grad(tqd, tX))
    _close(tS, S)
    _close(tq.rie_hess_vec(tqd, tX, tS, tV), jq.rie_hess_vec(jqd, jX, S, jV))
    _close(tq.precond_solve(tqd, tV), jq.precond_solve(jqd, jV))
    _close(tq.apply_precond(tqd, tX, tV), jq.apply_precond(jqd, jX, jV))
    np.testing.assert_allclose(float(tq.cost(tqd, tX)),
                               float(jq.cost(jqd, jX)), rtol=RTOL)
    np.testing.assert_allclose(float(tq.rie_grad_norm(tqd, tX)),
                               float(jq.rie_grad_norm(jqd, jX)), rtol=RTOL)


def test_csr_matvec_matches_jax_in_float32(monkeypatch):
    """min_edges=0 forces the CSR plans onto the 510 gather-path edges of
    city600; float32 input then takes the segment-sum branch (the plain
    version on the CPU), which must agree with the JAX float32 matvec."""
    r = 5
    jqd, tqd, n, d = _data("city600", r=r)
    assert tq.attach_csr_plans(tqd) is tqd  # below the 4096-edge threshold
    tcsr = tq.attach_csr_plans(tqd, min_edges=0).to(torch.float32)
    assert tcsr.csr.E_by_j.dtype == tcsr.csr.E_by_i.dtype == torch.float32
    assert tcsr.csr.src_by_j.dtype == torch.int64
    calls = []
    ref_fn = segsum.segment_sum_reference
    monkeypatch.setattr(segsum, "segment_sum_reference",
                        lambda c, p: calls.append(p) or ref_fn(c, p))
    _, V = _lifted_point(n, r, d, seed=6)
    got = tq.q_matvec(tcsr, torch.as_tensor(V, dtype=torch.float32))
    assert len(calls) == 2
    jqd32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x, jqd)
    ref32 = jq.q_matvec(jqd32, jnp.asarray(V, jnp.float32),
                        precision=jax.lax.Precision.HIGHEST)
    _close(got, ref32, rtol=2e-5)
    _close(got.double(), jq.q_matvec(jqd, jnp.asarray(V)), rtol=2e-5)


def test_unported_preconditioners_raise():
    _, tp, n, d = _problems("city600")
    for precond in ("tridiag", "banded", "auto"):
        with pytest.raises(NotImplementedError):
            tq.build_q_data(tp, 5, precond=precond)
    with pytest.raises(ValueError):
        tq.build_q_data(tp, 5, precond="cholmod")
