"""Parity of dpgo_tpu_torch.parallel.spmd (the synchronous RBCD round, the
agents a batch axis) with dpgo_tpu.parallel.spmd on one device.

Both packages get the identical team: the port's build_spmd_problem is held
to the JAX one array by array, and the rounds then run on the JAX problem
carried over by dpgo_tpu_torch.convert. Teams: synthesize_grid3d(125) in 4
agents at r = 5, synthesize_city2d(600) in 3 agents at d = 2, r = 3, and
grid3d(125) with some loop closures reversed (backward private edges,
p2 < p1, on their own band lanes). Float64 rounds agree to 1e-9 in X, Y, V
and 1e-10 relative in the metrics."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu.measurements import RelativeSEMeasurement as JMeas
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.parallel import partition as jpart
from dpgo_tpu.parallel import spmd as js
from dpgo_tpu.solvers.pgo import chordal_initialization
from dpgo_tpu_torch import convert
from dpgo_tpu_torch import datasets as td
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.measurements import RelativeSEMeasurement as TMeas
from dpgo_tpu_torch.parallel import partition as tpart
from dpgo_tpu_torch.parallel import spmd as ts

# name -> (synthesizer, num_poses, d, agents, r)
CASES = {
    "grid125": ("grid3d", 125, 3, 4, 5),
    "city600": ("city2d", 600, 2, 3, 3),
    "reversed": ("grid3d", 125, 3, 4, 5),
}


def _reverse_some_lcs(meas):
    """Every other loop closure i -> i + 3 or i -> i + 21 becomes a backward
    edge j -> i with the inverse relative pose (R^T, -R^T t): the same
    constraint. Few enough offsets that the band plan keeps every edge on a
    lane, the negative ones included."""
    out, k = [], 0
    for m in meas:
        if m.p2 - m.p1 in (3, 21):
            k += 1
            if k % 2 == 0:
                m = type(m)(m.r2, m.r1, m.p2, m.p1, m.R.T, -m.R.T @ m.t,
                            m.kappa, m.tau, m.weight, m.fixed_weight)
        out.append(m)
    return out


def measurements(name, cls):
    """The case's measurement list as `cls` instances (either package's
    RelativeSEMeasurement), from the numpy synthesizer."""
    kind, n, d, _, _ = CASES[name]
    synth = td.synthesize_grid3d if kind == "grid3d" else td.synthesize_city2d
    edges, n, _ = synth(n, seed=0)
    meas = [cls(m.r1, m.r2, m.p1, m.p2, m.R, m.t, m.kappa, m.tau, m.weight,
                m.fixed_weight) for m in edges.to_measurements()]
    if name == "reversed":
        meas = _reverse_some_lcs(meas)
    return meas, n


def jax_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), jax.Array)}


def jax_meta(p):
    return dict(num_agents=p.num_agents, n_max=p.n_max, d=p.d, r=p.r,
                num_band=p.num_band, band_offsets=p.band_offsets)


@functools.lru_cache(maxsize=None)
def team(name):
    """(jax problem, port problem, ranges, lifted chordal X0, jax state,
    port state, n) of a case."""
    _, _, d, A, r = CASES[name]
    meas, n = measurements(name, JMeas)
    jp, ranges = js.build_spmd_problem(meas, n, A, r)
    T = np.asarray(chordal_initialization(meas))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, r)), T)
    tp = convert.spmd_problem_from_numpy(jax_fields(jp), jax_meta(jp),
                                         device="cpu")
    jst = js.initial_state(jp, X0, ranges)
    tst = ts.initial_state(tp, X0, ranges, device="cpu")
    return jp, tp, ranges, X0, jst, tst, n


def jax_sel(cfg):
    return jnp.asarray(-1 if cfg["mode"] == "all" else 0, jnp.int32)


def run_steps(name, rounds=3, active=None, **kw):
    """`rounds` make_step_fn rounds of both packages from the same state;
    returns the final states, metrics and selection sequences."""
    jp, tp, _, _, jst, tst, _ = team(name)
    if active is not None:
        jp, tp = jp.with_robot_active(active), tp.with_robot_active(active)
    cfg = dict(mode="all", acceleration=True, rtr_iterations=1,
               rtr_gradnorm_tol=1e-3, nesterov_n=5)
    cfg.update(kw)
    jstep = js.make_step_fn(jp, js.SPMDConfig(**cfg))
    tstep = ts.make_step_fn(tp, ts.SPMDConfig(**cfg), device="cpu")
    sj, st = jst, tst
    selj, selt = jax_sel(cfg), int(jax_sel(cfg))
    sels = []
    for _ in range(rounds):
        sj, mj, selj = jstep(sj, selj)
        st, mt, selt = tstep(st, selt)
        sels.append((int(selj), selt))
    return sj, mj, st, mt, sels, tstep


def assert_state_close(st, sj, atol=1e-9, rtol=1e-10):
    """X, Y, V within atol; gamma and cost_X within rtol."""
    for k in ("X", "Y", "V"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(sj, k)), rtol=0, atol=atol)
    np.testing.assert_allclose(float(st.gamma), float(sj.gamma), rtol=rtol)
    assert int(st.it) == int(sj.it)
    assert bool(st.do_restart) == bool(sj.do_restart)
    if np.isfinite(float(sj.cost_X)):
        np.testing.assert_allclose(float(st.cost_X), float(sj.cost_X),
                                   rtol=rtol)


def assert_metrics_close(mt, mj, rtol=1e-10):
    for k in ("cost", "gradnorm", "max_rel_change"):
        np.testing.assert_allclose(float(getattr(mt, k)),
                                   float(getattr(mj, k)), rtol=rtol)


@pytest.mark.parametrize("name", list(CASES))
def test_partition_and_problem_identical(name):
    """partition_measurements gives the same lists and build_spmd_problem
    the same arrays and metadata, in both packages."""
    _, n, _, A, r = CASES[name]
    jm, n = measurements(name, JMeas)
    tm, _ = measurements(name, TMeas)
    jparts = jpart.partition_measurements(jm, n, A)
    tparts = tpart.partition_measurements(tm, n, A)
    assert jparts[3] == tparts[3] == tpart.contiguous_partition(n, A)
    for jl_, tl_ in zip(jparts[:3], tparts[:3]):
        for ja, ta in zip(jl_, tl_):
            assert len(ja) == len(ta)
            for a, b in zip(ja, ta):
                assert (a.r1, a.r2, a.p1, a.p2) == (b.r1, b.r2, b.p1, b.p2)
                np.testing.assert_array_equal(a.R, b.R)
                np.testing.assert_array_equal(a.t, b.t)
    jp = team(name)[0]
    tp, ranges = ts.build_spmd_problem(tm, n, A, r, device="cpu")
    assert ranges == team(name)[2]
    assert jax_meta(jp) == {k: getattr(tp, k) for k in jax_meta(jp)}
    for f in ts._DATA_FIELDS:
        ref = np.asarray(getattr(jp, f))
        got = getattr(tp, f).numpy()
        assert got.shape == ref.shape, f
        np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=f)
    if name == "reversed":
        kappa = np.asarray(jp.priv_kappa) > 0
        delta = np.asarray(jp.priv_j) - np.asarray(jp.priv_i)
        assert (delta[kappa] < 0).any()
        assert any(o < 0 for o in jp.band_offsets)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("grid125", dict(acceleration=False)),
        ("grid125", dict()),
        ("grid125", dict(adaptive_restart=True)),
        ("grid125", dict(restart_interval=2, nesterov_n=None)),
        ("grid125", dict(precond="tridiag")),
        ("grid125", dict(precond="jacobi")),
        ("grid125", dict(precond="banded", rtr_iterations=2)),
        ("city600", dict(adaptive_restart=True)),
        ("city600", dict(acceleration=False, precond="tridiag")),
        ("reversed", dict(acceleration=False)),
        ("reversed", dict(adaptive_restart=True)),
    ],
)
def test_rounds_match_jax(name, kw):
    """Three rounds of 'all' (plain, accelerated, adaptive and periodic
    restarts, each preconditioner, a two-iteration local RTR budget)."""
    sj, mj, st, mt, sels, step = run_steps(name, **kw)
    assert_state_close(st, sj)
    assert_metrics_close(mt, mj)
    assert all(a == b == -1 for a, b in sels)
    expect = kw.get("precond", "banded")
    assert step.precond == ("banded" if expect == "auto" else expect)


def test_greedy_rounds_match_jax():
    """Greedy: one agent solves, the others pay the metric pass; the
    selected agents match round by round."""
    sj, mj, st, mt, sels, _ = run_steps("grid125", rounds=4, mode="greedy",
                                        adaptive_restart=True)
    assert_state_close(st, sj)
    assert_metrics_close(mt, mj)
    assert all(a == b for a, b in sels) and len({a for a, _ in sels}) > 1


@pytest.mark.parametrize("mode", ["all", "greedy"])
def test_inactive_robot_matches_jax(mode):
    """Robot 1 inactive: its block stays frozen, its shared edges drop out
    of the others' problems, and it is left out of the metrics."""
    _, _, _, _, _, tst, _ = team("grid125")
    active = [True, False, True, True]
    sj, mj, st, mt, sels, _ = run_steps("grid125", active=active, mode=mode)
    assert_state_close(st, sj)
    assert_metrics_close(mt, mj)
    assert torch.equal(st.X[1], tst.X[1])
    assert all(a == b != 1 for a, b in sels)
    # keeping the inactive neighbor's frozen pose instead
    sj, mj, st, mt, _, _ = run_steps("grid125", active=active, mode=mode,
                                     use_inactive_neighbors=True)
    assert_state_close(st, sj)
    assert_metrics_close(mt, mj)


def test_auto_resolves_like_jax_without_the_stacked_plan(monkeypatch):
    """With the stacked banded plan over its memory cap, 'auto' gives each
    agent the tridiagonal factor in both packages."""
    monkeypatch.setattr(js, "_BANDED_AUTO_BYTES", 0)
    monkeypatch.setattr(ts, "_BANDED_AUTO_BYTES", 0)
    sj, mj, st, mt, _, step = run_steps("grid125", rounds=2)
    assert step.precond == "tridiag"
    assert_state_close(st, sj)
    assert_metrics_close(mt, mj)


@pytest.mark.parametrize("control", [False, True])
def test_mixed_precision_round_matches_jax(control):
    """Float32 tCG and the mixed Newton-Schulz projections, with float64
    control or (the fast phase's round) float32 control matvecs too: X, Y,
    V and the cost within 1e-5. The gradnorm metric within 1e-4: it is
    taken at Y, whose float32 Newton-Schulz bulk the two packages round
    differently (~1e-7), and the gradient, small against |X Q| near the
    optimum, magnifies that to ~1e-5 of its norm."""
    sj, mj, st, mt, _, _ = run_steps(
        "grid125", rounds=1, rtr_inner_dtype="float32", adaptive_restart=True,
        rtr_inner_control_matvecs=control)
    assert_state_close(st, sj, atol=1e-5, rtol=1e-5)
    for k, rtol in (("cost", 1e-5), ("max_rel_change", 1e-5),
                    ("gradnorm", 1e-4)):
        np.testing.assert_allclose(float(getattr(mt, k)),
                                   float(getattr(mj, k)), rtol=rtol)


def test_metrics_match_the_central_objective():
    """The team's cost metric is the global objective <X Q, X> = 2 f at the
    round-start iterate, backward edges included, and the gradnorm metric
    its Riemannian gradient norm."""
    jp, tp, ranges, X0, _, tst, n = team("reversed")
    meas, _ = measurements("reversed", TMeas)
    from dpgo_tpu_torch.measurements import EdgeArrays

    edges = EdgeArrays.from_measurements(meas)
    lp = tq.from_private_measurements(edges, n=n, d=3, device="cpu")
    qd = tq.build_quadratic_data(lp, torch.zeros((1, 5, 4), dtype=torch.float64),
                                 r=5)
    step = ts.make_step_fn(tp, ts.SPMDConfig(acceleration=False), device="cpu")
    _, m, _ = step(tst, -1)
    X = torch.as_tensor(ts.assemble_global(tst, ranges, n))
    np.testing.assert_allclose(float(m.cost), 2 * float(tq.cost(qd, X)),
                               rtol=1e-10)
    np.testing.assert_allclose(float(m.gradnorm), float(tq.rie_grad_norm(qd, X)),
                               rtol=1e-9)
