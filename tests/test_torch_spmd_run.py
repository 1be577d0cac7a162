"""The SPMD engine's drivers (make_run_fn, make_two_phase_run_fn,
run_rbcd_spmd) in both packages on the same inputs: round counts agree
exactly and costs to 1e-8 relative (float64). The batched RTR solve under
them and rtr_solve_auto: tests/test_torch_rtr_auto.py."""

import dataclasses

import numpy as np
import pytest
import torch

from dpgo_tpu.parallel import spmd as js
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_spmd import assert_metrics_close, team

CFG = dict(mode="all", acceleration=True, rtr_iterations=1,
           rtr_gradnorm_tol=1e-3, adaptive_restart=True,
           restart_interval=10**6, nesterov_n=5)


@pytest.mark.parametrize("name,kw", [
    ("grid125", dict()),
    ("grid125", dict(mode="greedy")),
    ("city600", dict(precond="tridiag")),
])
def test_run_fn_matches_jax(name, kw):
    """Ten rounds, then to a tolerance the team reaches within them: the
    same round counts and costs."""
    jp, tp, _, _, jst, tst, _ = team(name)
    cfg = dict(CFG, **kw)
    jrun = js.make_run_fn(jp, js.SPMDConfig(**cfg))
    trun = ts.make_run_fn(tp, ts.SPMDConfig(**cfg), device="cpu")
    sj, mj, rj = jrun(jst, 10, 0.0)
    st, mt, rt = trun(tst, 10, 0.0)
    assert int(rj) == rt == 10
    assert_metrics_close(mt, mj, rtol=1e-8)
    np.testing.assert_allclose(st.X.numpy(), np.asarray(sj.X), rtol=0,
                               atol=1e-7)
    tol = 2.0 * float(mj.gradnorm)
    sj, mj, rj = jrun(jst, 10, tol)
    st, mt, rt = trun(tst, 10, tol)
    assert int(rj) == rt < 10
    assert_metrics_close(mt, mj, rtol=1e-8)
    # the relative-change gate
    rel = 2.0 * float(mj.max_rel_change)
    _, mj, rj = jrun(jst, 10, 0.0, rel_tol=rel)
    _, mt, rt = trun(tst, 10, 0.0, rel_tol=rel)
    assert int(rj) == rt
    assert_metrics_close(mt, mj, rtol=1e-8)


def test_run_fn_takes_a_reweighted_problem():
    """A run given another problem of the same shapes (halved loop-closure
    weights) builds its data for that one, as the JAX driver does."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    jw = dataclasses.replace(jp, priv_weight=jp.priv_weight * 0.5)
    tw = dataclasses.replace(tp, priv_weight=tp.priv_weight * 0.5)
    jrun = js.make_run_fn(jp, js.SPMDConfig(**CFG))
    trun = ts.make_run_fn(tp, ts.SPMDConfig(**CFG), device="cpu")
    _, mj, _ = jrun(jst, 4, 0.0, problem=jw)
    _, mt, _ = trun(tst, 4, 0.0, problem=tw)
    assert_metrics_close(mt, mj, rtol=1e-8)


@pytest.mark.parametrize("mixed", [False, True])
def test_two_phase_run_matches_jax(mixed):
    """Float64: the plain driver. Mixed: the fast phase (float32 control
    matvecs) until gradnorm < 4 tol, then the exact phase; the tolerance is
    set so that the switch falls inside the ten rounds."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    cfg = dict(CFG, rtr_inner_dtype="float32" if mixed else None)
    jrun = js.make_two_phase_run_fn(jp, js.SPMDConfig(**cfg))
    trun = ts.make_two_phase_run_fn(tp, ts.SPMDConfig(**cfg), device="cpu")
    _, m5, _ = js.make_run_fn(jp, js.SPMDConfig(**cfg))(jst, 5, 0.0)
    tol = float(m5.gradnorm) / 4.0 * 1.01 if mixed else 0.0
    sj, mj, rj = jrun(jst, 10, tol)
    st, mt, rt = trun(tst, 10, tol)
    assert rj == rt
    if mixed:
        assert trun.switch_round == 5
        # costs of the exact phase, from iterates of a float32 tCG
        np.testing.assert_allclose(float(mt.cost), float(mj.cost), rtol=1e-8)
    else:
        assert rt == 10 and trun.switch_round is None
        assert_metrics_close(mt, mj, rtol=1e-8)


def test_two_phase_run_builds_and_casts_its_data_once(monkeypatch):
    """Mixed mode: both phases share one build of the team's data, and the
    tCG's float32 copy is cast there, not in every round."""
    _, tp, _, _, _, tst, _ = team("grid125")
    builds, casts = [], []
    build, to = ts._build_team, tq.QuadraticData.to
    monkeypatch.setattr(ts, "_build_team",
                        lambda *a: builds.append(1) or build(*a))
    monkeypatch.setattr(tq.QuadraticData, "to",
                        lambda self, dt: casts.append(dt) or to(self, dt))
    cfg = ts.SPMDConfig(**dict(CFG, rtr_inner_dtype="float32"))
    trun = ts.make_two_phase_run_fn(tp, cfg, device="cpu")
    assert (len(builds), casts) == (1, [torch.float32])
    assert trun.precond == "banded" and trun.splan is not None
    _, m, rounds = trun(tst, 6, 0.0)
    assert rounds == 6 and len(builds) == 1 and len(casts) == 1
    assert np.isfinite(float(m.cost))


def test_run_rbcd_spmd_matches_jax():
    jp, tp, _, _, jst, tst, _ = team("city600")
    cfg = dict(CFG, mode="greedy", acceleration=False)
    _, jt = js.run_rbcd_spmd(jp, jst, js.SPMDConfig(**cfg), num_rounds=12,
                             gradnorm_tol=0.0, check_every=5)
    _, tt = ts.run_rbcd_spmd(tp, tst, ts.SPMDConfig(**cfg), num_rounds=12,
                             gradnorm_tol=0.0, check_every=5, device="cpu")
    assert jt["rounds"] == tt["rounds"] == 12
    np.testing.assert_allclose(tt["cost"], jt["cost"], rtol=1e-8)
    np.testing.assert_allclose(tt["gradnorm"], jt["gradnorm"], rtol=1e-8)


def test_assemble_global_matches_jax():
    jp, tp, ranges, X0, jst, tst, n = team("city600")
    np.testing.assert_array_equal(ts.assemble_global(tst, ranges, n),
                                  js.assemble_global(jst, ranges, n))
    np.testing.assert_allclose(ts.assemble_global(tst, ranges, n), X0,
                               rtol=0, atol=1e-15)


def test_unported_options_raise():
    """A mesh is still not ported; the randomized modes are (and build)."""
    _, tp, _, _, _, tst, _ = team("grid125")
    for kw in (dict(mode="uniform"), dict(mode="async", acceleration=False)):
        assert callable(ts.make_step_fn(tp, ts.SPMDConfig(**kw), device="cpu"))
    with pytest.raises(NotImplementedError):
        ts.make_run_fn(tp, ts.SPMDConfig(), mesh=object(), device="cpu")
    for kw in (dict(mode="sync"), dict(precond="cholmod")):
        with pytest.raises(ValueError):
            ts.make_step_fn(tp, ts.SPMDConfig(**kw), device="cpu")


def test_drivers_default_to_the_card():
    """Without a device argument the drivers run on the CUDA card, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this checks the machine without a card")
    _, tp, ranges, X0, _, tst, _ = team("grid125")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ts.make_run_fn(tp, ts.SPMDConfig())
    with pytest.raises(RuntimeError, match="CUDA card"):
        ts.initial_state(tp, X0, ranges)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ts.build_spmd_problem([], 10, 2, 5)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ts.run_rbcd_gnc(tp, tst, ts.SPMDConfig(acceleration=False))
    with pytest.raises(RuntimeError, match="CUDA card"):
        ts.load_state("nowhere.npz")
    from dpgo_tpu_torch.solvers import pgo

    with pytest.raises(RuntimeError, match="CUDA card"):
        pgo.solve_robust_pgo([])
