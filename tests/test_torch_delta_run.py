"""Parity of the delta engine's run functions (dpgo_tpu_torch.parallel.delta:
_delta_round and make_delta_run_fn) with dpgo_tpu.parallel.delta, on the
CPU, on tests/test_torch_delta.py's teams.

Both packages start from the same anchor and, where a test injects one, the
same mid-run state (dpgo_tpu_torch.convert). Float32 rounds agree within
1e-5 of each quantity's scale: the metrics, the deltas and the restart
decision under each restart_scheme, and across re-anchoring calls. Elastic
membership, GNC and run_delta_certified are in
tests/test_torch_delta_gnc.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu.parallel import delta as jdm
from dpgo_tpu.parallel import spmd as js
from dpgo_tpu_torch import convert
from dpgo_tpu_torch.parallel import delta as tdm
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_delta import close, team

CFG = dict(mode="all", acceleration=True, rtr_iterations=1,
           rtr_gradnorm_tol=1e-3, adaptive_restart=True,
           restart_interval=10**6, nesterov_n=5, rtr_tcg_iterations=20)


@functools.lru_cache(maxsize=None)
def run_fns(name, reanchor_every=0, **kw):
    """Both packages' make_delta_run_fn for a case under CFG updated by
    kw."""
    jp, tp, *_ = team(name)
    cfg = dict(CFG, **kw)
    return (jdm.make_delta_run_fn(jp, js.SPMDConfig(**cfg),
                                  reanchor_every=reanchor_every),
            tdm.make_delta_run_fn(tp, ts.SPMDConfig(**cfg),
                                  reanchor_every=reanchor_every,
                                  device="cpu"))


def to_port(jref, jst):
    def arrays(t):
        return {k: np.asarray(v) for k, v in t._asdict().items()}

    return (convert.delta_ref_from_numpy(arrays(jref), device="cpu"),
            convert.delta_state_from_numpy(arrays(jst), device="cpu"))


def metrics_close(tm, jm, jst):
    """Cost and gradient norm within 1e-5 relative; the relative change, a
    difference of deltas, within 1e-5 of the displacement ACC + D."""
    close(tm.cost, jm.cost)
    close(tm.gradnorm, jm.gradnorm)
    disp = float(np.abs(np.asarray(jst.ACC) + np.asarray(jst.D)).max())
    close(tm.max_rel_change, jm.max_rel_change,
          scale=max(float(jm.max_rel_change), disp))


def assert_round_close(tst, jst, tm, jm):
    for f in ("D", "DY", "DV", "ACC"):
        j = np.asarray(getattr(jst, f))
        close(getattr(tst, f), j, scale=max(float(np.abs(j).max()), 1e-3))
    assert tst.it == int(jst.it)
    assert bool(tst.do_restart) == bool(jst.do_restart)
    close(tst.gamma, jst.gamma)
    metrics_close(tm, jm, jst)


@pytest.mark.parametrize("scheme", ["cost", "exact", "gradient"])
@pytest.mark.parametrize("fire", [False, True])
def test_delta_round_matches_jax(scheme, fire):
    """Two single rounds (_delta_round through make_delta_run_fn) from the
    same mid-run state under each restart_scheme: with fire, the state's
    Nesterov aux delta DV is thrown far off, so the adaptive restart fires
    after the first round and the second is a restart round; without, no
    restart. Deltas, restart decision and metrics agree."""
    jp, tp, _, Xs, _, _ = team("grid125")
    jrun, trun = run_fns("grid125", restart_scheme=scheme)
    jref = jdm.build_delta_ref(jp, Xs)
    jst, jref, _, _ = jrun(jref, jdm.initial_delta_state(jref), 3, 0.0)
    if fire:
        kick = 2.0 * np.random.default_rng(0).standard_normal(Xs.shape)
        jst = jst._replace(DV=jst.DV + jnp.asarray(kick, jnp.float32))
    tref, tst = to_port(jref, jst)
    for k in range(2):
        jst, jref, jm, jr = jrun(jref, jst, 1, 0.0)
        tst, tref, tm, tr = trun(tref, tst, 1, 0.0)
        assert tr == int(jr) == 1
        assert_round_close(tst, jst, tm, jm)
        if k == 0:
            assert bool(tst.do_restart) == fire


@pytest.mark.parametrize("name", ["grid125", "city600"])
def test_run_fn_across_reanchoring_calls(name):
    """make_delta_run_fn with reanchor_every = 3 (folds at cumulative rounds
    3, 6, 9: inside a call and on a call's last round) and a periodic
    restart every 5 rounds, over calls of 4, 4 and up to 40 rounds (the
    last to gradnorm 0.02): the same metrics and round counts as the JAX
    package, the returned anchors within 1e-5 of scale."""
    jp, tp, _, Xs, _, _ = team(name)
    cap = 20 if name == "grid125" else 3
    jrun, trun = run_fns(name, 3, restart_scheme="exact", restart_interval=5,
                         rtr_tcg_iterations=cap)
    jref = jdm.build_delta_ref(jp, Xs)
    jst = jdm.initial_delta_state(jref)
    tref = tdm.build_delta_ref(tp, Xs, device="cpu")
    tst = tdm.initial_delta_state(tref)
    for rounds, tol in ((4, 0.0), (4, 0.0), (40, 0.02)):
        jst, jref, jm, jr = jrun(jref, jst, rounds, tol)
        tst, tref, tm, tr = trun(tref, tst, rounds, tol)
        assert tr == int(jr)
        metrics_close(tm, jm, jst)
        for f in ("res_ref_priv", "res_ref_shared", "X_ref"):
            close(getattr(tref, f), getattr(jref, f))
    assert tst.it == int(jst.it) and 0 < tr < 40
    assert float(tm.gradnorm) < 0.02


def test_mesh_raises():
    _, tp, *_ = team("city600")
    with pytest.raises(NotImplementedError):
        tdm.make_delta_run_fn(tp, ts.SPMDConfig(), mesh=object(),
                              device="cpu")
    with pytest.raises(ValueError):
        tdm.make_delta_run_fn(tp, ts.SPMDConfig(restart_scheme="exct"),
                              device="cpu")
