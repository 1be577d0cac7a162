"""Distributed GNC in both packages: the lifted residuals, the GNC-TLS
reweighting (fixed weights, an inactive neighbor), the run_rbcd_gnc schedule
and the edge weight table.

Teams: synthesize_grid3d(125) in 4 agents, the two-robot world of
tests/test_distributed_robust.py (8 poses, three clean cross-robot loop
closures and one outlier) rebuilt from a seed, and synthesize_city2d(200)
with 10% planted outliers in 2 agents. Float64: residuals and one reweighting
agree to 1e-12, the weights after the whole schedule to 1e-8."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu.measurements import RelativeSEMeasurement as JMeas
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.parallel import spmd as js
from dpgo_tpu.solvers.averaging import project_to_rotation_group
from dpgo_tpu.solvers.pgo import chordal_initialization
from dpgo_tpu_torch import convert
from dpgo_tpu_torch.ops import block_tridiag
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_spmd import jax_fields, jax_meta, team


def _two_robot_world(seed, n=8):
    """n poses over 2 robots: clean odometry, three clean cross-robot loop
    closures and one garbage one (1 -> n/2 + 3)."""
    rng = np.random.default_rng(seed)
    d = 3
    Rw = [project_to_rotation_group(rng.standard_normal((d, d)))
          for _ in range(n)]
    tw = [2.0 * rng.standard_normal(d) for _ in range(n)]

    def rel(i, j):
        return JMeas(0, 0, i, j, Rw[i].T @ Rw[j], Rw[i].T @ (tw[j] - tw[i]),
                     10.0, 1.0)

    meas = [rel(i, i + 1) for i in range(n - 1)]
    half = n // 2
    meas += [rel(k, half + k) for k in range(3)]
    meas.append(JMeas(
        0, 0, 1, half + 3,
        project_to_rotation_group(rng.standard_normal((d, d))),
        tw[half + 3] - tw[1] + 30.0 + rng.standard_normal(d), 10.0, 1.0))
    return meas, n, (1, half + 3)


def _teams(meas, n, d, agents, r):
    """(jax problem, port problem, jax state, port state, ranges) from one
    measurement list, lifted chordal initialization."""
    jp, ranges = js.build_spmd_problem(meas, n, agents, r)
    T = np.asarray(chordal_initialization(meas))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, r)), T)
    tp = convert.spmd_problem_from_numpy(jax_fields(jp), jax_meta(jp),
                                         device="cpu")
    return (jp, tp, js.initial_state(jp, X0, ranges),
            ts.initial_state(tp, X0, ranges, device="cpu"), ranges)


def _assert_weights_close(tp, jp, atol):
    for f in ("priv_weight", "shared_weight"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=0,
                                   atol=atol, err_msg=f)


def _perturbed(jst, tst, seed=0, scale=0.05):
    """Both states moved off the initialization by the same noise, so that
    residuals spread over the GNC thresholds."""
    rng = np.random.default_rng(seed)
    E = scale * rng.standard_normal(tst.X.shape)
    return (jst._replace(X=jst.X + jnp.asarray(E)),
            tst._replace(X=tst.X + torch.as_tensor(E)))


@pytest.mark.parametrize("name", ["grid125", "city600"])
def test_gnc_residuals_match_jax(name):
    jp, tp, _, _, jst, tst, _ = team(name)
    jst, tst = _perturbed(jst, tst)
    jr_p, jr_s = js._gnc_residuals_sq(jp, jst)
    tr_p, tr_s = ts._gnc_residuals_sq(tp, tst)
    for got, ref in ((tr_p, jr_p), (tr_s, jr_s)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * ref.max())
    # padded edges report 0
    assert float(tr_p[tp.priv_kappa == 0].abs().max()) == 0.0


@pytest.mark.parametrize("mu", [2.0, 8.0])
def test_gnc_reweight_matches_jax(mu):
    """One reweighting at thresholds the residuals straddle: fixed-weight
    edges (odometry, and here every fourth shared edge) keep their weight,
    and so do the shared edges to the inactive robot 2."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    jst, tst = _perturbed(jst, tst)
    fixed = np.asarray(jp.shared_fixed_weight).copy()
    fixed[:, ::4] = True
    w0 = np.asarray(jp.shared_weight) * 0.5
    active = [True, True, False, True]
    jp = dataclasses.replace(jp, shared_fixed_weight=jnp.asarray(fixed),
                             shared_weight=jnp.asarray(w0)
                             ).with_robot_active(active)
    tp = dataclasses.replace(tp, shared_fixed_weight=torch.as_tensor(fixed),
                             shared_weight=torch.as_tensor(w0)
                             ).with_robot_active(active)
    r_sq = np.concatenate([np.asarray(x).ravel()
                           for x in js._gnc_residuals_sq(jp, jst)])
    barc_sq = float(np.median(r_sq[r_sq > 0]))
    jout = js.gnc_reweight(jp, jst, barc_sq, mu)
    tout = ts.gnc_reweight(tp, tst, barc_sq, mu)
    _assert_weights_close(tout, jout, atol=1e-12)
    w = tout.shared_weight.numpy()
    real = np.asarray(jp.shared_kappa) > 0
    keep = fixed | (np.asarray(jp.shared_nbr_robot) == 2)
    np.testing.assert_array_equal(w[keep], w0[keep])
    free = tout.priv_weight.numpy()[(~np.asarray(jp.priv_fixed_weight))
                                    & (np.asarray(jp.priv_kappa) > 0)]
    moved = np.concatenate([free, w[real & ~keep]])
    # the update decided some edges each way and left some in between
    assert (moved == 0).any() and (moved == 1).any()
    assert mu > 2.0 or ((moved > 0) & (moved < 1)).any()
    np.testing.assert_array_equal(
        tout.priv_weight.numpy()[np.asarray(jp.priv_fixed_weight)],
        np.asarray(jp.priv_weight)[np.asarray(jp.priv_fixed_weight)])


def _by_pair(table):
    return {e["pair"]: e["weight"] for e in table if not e["fixed"]}


@pytest.mark.parametrize("init_mu", [None, 0.5])
def test_run_rbcd_gnc_two_robot_world_matches_jax(init_mu):
    """The whole schedule on the two-robot world (the adaptive init_mu=None
    rule and a given mu): the same rounds per phase, costs and mu, weights
    within 1e-8, the outlier rejected and the clean loop closures kept."""
    meas, n, outlier = _two_robot_world(70)
    jp, tp, jst, tst, ranges = _teams(meas, n, 3, 2, 5)
    cfg = dict(mode="all", acceleration=False, rtr_iterations=1)
    kw = dict(barc=5.0, init_mu=init_mu, num_weight_updates=16,
              inner_rounds=15, rel_change_tol=1e-3)
    jout, jsf, jh = js.run_rbcd_gnc(jp, jst, js.SPMDConfig(**cfg), **kw)
    tout, tsf, th = ts.run_rbcd_gnc(tp, tst, ts.SPMDConfig(**cfg),
                                    device="cpu", **kw)
    assert [h["rounds"] for h in th] == [h["rounds"] for h in jh]
    np.testing.assert_allclose([h["mu"] for h in th], [h["mu"] for h in jh],
                               rtol=1e-9)
    np.testing.assert_allclose([h["cost"] for h in th],
                               [h["cost"] for h in jh], rtol=1e-8)
    _assert_weights_close(tout, jout, atol=1e-8)
    np.testing.assert_allclose(tsf.X.numpy(), np.asarray(jsf.X), rtol=0,
                               atol=1e-7)
    table = ts.edge_weight_table(tout, ranges)
    assert table == js.edge_weight_table(
        convert_back(tout, jout), ranges)
    w = _by_pair(table)
    if init_mu is None:
        assert w[outlier] < 1e-6
        assert all(w[(k, n // 2 + k)] > 0.99 for k in range(3))
    # both endpoint copies of a shared edge carry the same weight
    copies = [e["weight"] for e in table if e["pair"] == outlier]
    assert len(copies) == 2 and copies[0] == copies[1]


def convert_back(tout, jout):
    """The JAX problem with the port's final weights, for the JAX package's
    edge_weight_table."""
    return dataclasses.replace(
        jout, priv_weight=jnp.asarray(tout.priv_weight.numpy()),
        shared_weight=jnp.asarray(tout.shared_weight.numpy()))


def test_run_rbcd_gnc_planted_outliers_match_jax():
    """city2d(200) with 10% planted full-confidence outlier loop closures
    in 2 agents (the JAX package's scoring test): the port rejects exactly
    the planted edges, as the JAX package does, and the edge tables are
    equal up to 1e-8 in the weights."""
    edges, n, _ = jd.synthesize_city2d(200, seed=3)
    meas, planted = jd.plant_outliers(edges.to_measurements(), n, frac=0.10,
                                      seed=5)
    jp, tp, jst, tst, ranges = _teams(meas, n, 2, 2, 3)
    cfg = dict(mode="all", acceleration=False, rtr_iterations=1)
    kw = dict(barc=5.0, num_weight_updates=8, inner_rounds=15)
    jout, _, jh = js.run_rbcd_gnc(jp, jst, js.SPMDConfig(**cfg), **kw)
    tout, _, th = ts.run_rbcd_gnc(tp, tst, ts.SPMDConfig(**cfg),
                                  device="cpu", **kw)
    assert [h["rounds"] for h in th] == [h["rounds"] for h in jh]
    _assert_weights_close(tout, jout, atol=1e-8)
    ttab, jtab = ts.edge_weight_table(tout, ranges), \
        js.edge_weight_table(jout, ranges)
    assert [(e["pair"], e["fixed"], e["shared"]) for e in ttab] == \
        [(e["pair"], e["fixed"], e["shared"]) for e in jtab]
    np.testing.assert_allclose([e["weight"] for e in ttab],
                               [e["weight"] for e in jtab], rtol=0, atol=1e-8)
    assert {e["pair"] for e in ttab} == {(m.p1, m.p2) for m in meas}
    rejected = {p for p, w in _by_pair(ttab).items() if w < 1e-6}
    assert rejected == planted
    assert rejected == {p for p, w in _by_pair(jtab).items() if w < 1e-6}


def test_reweighted_problem_reaches_the_banded_factor():
    """A run given a reweighted problem rebuilds the Q blocks and the exact
    banded factor from the new weights (same plan, other values): it equals
    a run function built for the reweighted problem, and the JAX package's."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    jst, tst = _perturbed(jst, tst, scale=0.02)
    r_max = float(max(jnp.max(x) for x in js._gnc_residuals_sq(jp, jst)))
    jw = js.gnc_reweight(jp, jst, 0.3 * r_max, 0.5)
    tw = ts.gnc_reweight(tp, tst, 0.3 * r_max, 0.5)
    cfg = dict(mode="all", acceleration=False, rtr_iterations=1,
               precond="banded")
    tcfg = ts.SPMDConfig(**cfg)
    run = ts.make_run_fn(tp, tcfg, device="cpu")
    assert run.precond == "banded"
    base = ts._Teams(tp, tcfg, run.splan).all.qd
    rew = ts._Teams(tw, tcfg, run.splan).all.qd
    assert isinstance(rew.btf, block_tridiag.BandedFactor)

    def floats(obj):
        """Every floating tensor in a (nested) dataclass, tuple or list."""
        if torch.is_tensor(obj):
            return [obj] if obj.is_floating_point() else []
        if dataclasses.is_dataclass(obj):
            obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        if isinstance(obj, (tuple, list)):
            return [t for x in obj for t in floats(x)]
        return []

    pairs = list(zip(floats(rew.btf), floats(base.btf)))
    assert pairs and all(a.shape == b.shape for a, b in pairs)
    assert any(not torch.equal(a, b) for a, b in pairs)
    assert not torch.equal(rew.diag, base.diag)
    np.testing.assert_array_equal(rew.btf.perm.numpy(), base.btf.perm.numpy())
    s1, m1, _ = run(tst, 3, 0.0, problem=tw)
    s2, m2, _ = ts.make_run_fn(tw, tcfg, device="cpu")(tst, 3, 0.0)
    assert torch.equal(s1.X, s2.X) and float(m1.cost) == float(m2.cost)
    s0, _, _ = run(tst, 3, 0.0)
    assert not torch.equal(s0.X, s1.X)
    sj, mj, _ = js.make_run_fn(jp, js.SPMDConfig(**cfg))(jst, 3, 0.0,
                                                         problem=jw)
    np.testing.assert_allclose(s1.X.numpy(), np.asarray(sj.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(float(m1.cost), float(mj.cost), rtol=1e-10)
