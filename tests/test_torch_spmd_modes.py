"""The randomized update modes of the SPMD engine, 'uniform' and 'async', in
both packages.

The JAX package draws from jax.random.fold_in(PRNGKey(seed), it), which torch
cannot reproduce; so the tests compute the JAX package's own draws with
jax.random and inject them into the port through `selections`. Round by
round the states then agree to 1e-9 and the metrics to 1e-10 relative, as in
the deterministic modes. The port's own draw (a torch.Generator seeded with
(cfg.seed, round counter)) is the same at the same round whatever the call
pattern and differs across seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.parallel import spmd as js
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_spmd import (assert_metrics_close, assert_state_close,
                                   team)

BASE = dict(rtr_iterations=1, rtr_gradnorm_tol=1e-3, nesterov_n=5)


def jax_uniform_draws(seed, N, rounds):
    """The JAX package's selection drawn after the round that started at
    counter it, for it = 0 .. rounds-1 (_select_next)."""
    key = jax.random.PRNGKey(seed)
    return [int(jax.random.randint(jax.random.fold_in(key, it), (), 0, N,
                                   jnp.int32)) for it in range(rounds)]


def jax_async_masks(seed, N, rounds, rate):
    """The JAX package's firing mask of the round that starts at counter it
    (_round_body)."""
    key = jax.random.PRNGKey(seed)
    p_fire = 1.0 - float(np.exp(-rate))
    return [np.asarray(jax.random.bernoulli(jax.random.fold_in(key, it),
                                            p_fire, (N,)))
            for it in range(rounds)]


def run_both(name, cfg, selections, rounds, active=None):
    jp, tp, _, _, jst, tst, _ = team(name)
    if active is not None:
        jp, tp = jp.with_robot_active(active), tp.with_robot_active(active)
    jstep = js.make_step_fn(jp, js.SPMDConfig(**cfg))
    tstep = ts.make_step_fn(tp, ts.SPMDConfig(**cfg), device="cpu",
                            selections=selections)
    first = -1 if cfg["mode"] == "async" else 0
    sj, st, selj, selt = jst, tst, jnp.asarray(first, jnp.int32), first
    sels = []
    for _ in range(rounds):
        sj, mj, selj = jstep(sj, selj)
        st, mt, selt = tstep(st, selt)
        sels.append((int(selj), selt))
        assert_state_close(st, sj)
        assert_metrics_close(mt, mj)
    return sels, st


@pytest.mark.parametrize("name,kw", [
    ("grid125", dict(acceleration=False)),
    ("grid125", dict(acceleration=True, adaptive_restart=True)),
    ("city600", dict(acceleration=False, seed=3)),
])
def test_uniform_rounds_match_jax(name, kw):
    """Six rounds of 'uniform' with the JAX package's draws injected: the
    same agent solves in each round (the first round solves agent 0) and
    states and metrics agree round by round."""
    cfg = dict(BASE, mode="uniform", **kw)
    N = team(name)[1].num_agents
    draws = jax_uniform_draws(cfg.get("seed", 0), N, 6)
    sels, _ = run_both(name, cfg, draws, 6)
    assert [a for a, _ in sels] == [b for _, b in sels] == draws
    assert len(set(draws)) > 1


@pytest.mark.parametrize("name,kw", [
    ("grid125", dict()),
    ("grid125", dict(async_rate=0.3, seed=5)),
    ("city600", dict()),
])
def test_async_rounds_match_jax(name, kw):
    """Six rounds of 'async' with the JAX package's firing masks injected
    (a mapping from the round counter, here): only the firing agents move."""
    cfg = dict(BASE, mode="async", acceleration=False, **kw)
    N = team(name)[1].num_agents
    masks = jax_async_masks(cfg.get("seed", 0), N, 6,
                            cfg.get("async_rate", 0.7))
    assert 0 < sum(int(m.sum()) for m in masks) < 6 * N
    sels, st = run_both(name, cfg, dict(enumerate(masks)), 6)
    assert all(a == b == -1 for a, b in sels)
    # an agent that never fired did not move
    tst = team(name)[5]
    for a in range(N):
        if not any(m[a] for m in masks):
            assert torch.equal(st.X[a], tst.X[a])


def test_async_and_uniform_with_an_inactive_robot_match_jax():
    """Robot 1 inactive: it never solves, whatever the draw says."""
    active = [True, False, True, True]
    draws = [1, 2, 1, 3]
    tst = team("grid125")[5]
    # the JAX package's own draws differ, so it is driven by hand here: the
    # port's injected selections against the JAX step given the same sel
    jp, tp = team("grid125")[0].with_robot_active(active), \
        team("grid125")[1].with_robot_active(active)
    cfg = dict(BASE, mode="uniform", acceleration=False)
    jstep = js.make_step_fn(jp, js.SPMDConfig(**cfg))
    tstep = ts.make_step_fn(tp, ts.SPMDConfig(**cfg), device="cpu",
                            selections=draws)
    sj, st, sel = team("grid125")[4], tst, 0
    for k in range(4):
        sj, mj, _ = jstep(sj, jnp.asarray(sel, jnp.int32))
        st, mt, nxt = tstep(st, sel)
        assert nxt == draws[k]
        sel = nxt
        assert_state_close(st, sj)
        assert_metrics_close(mt, mj)
    assert torch.equal(st.X[1], tst.X[1])
    masks = jax_async_masks(0, 4, 4, 0.7)
    cfg = dict(BASE, mode="async", acceleration=False)
    _, st = run_both("grid125", cfg, masks, 4, active=active)
    assert torch.equal(st.X[1], tst.X[1])


@pytest.mark.parametrize("mode", ["uniform", "async"])
def test_run_fn_with_injected_draws_matches_jax(mode):
    """make_run_fn and run_rbcd_spmd take the injected draws too: eight
    rounds, costs and gradnorms to 1e-8."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    cfg = dict(BASE, mode=mode, acceleration=False)
    draws = (jax_uniform_draws(0, 4, 8) if mode == "uniform"
             else jax_async_masks(0, 4, 8, 0.7))
    sj, mj, rj = js.make_run_fn(jp, js.SPMDConfig(**cfg))(jst, 8, 0.0)
    trun = ts.make_run_fn(tp, ts.SPMDConfig(**cfg), device="cpu",
                          selections=draws)
    st, mt, rt = trun(tst, 8, 0.0)
    assert int(rj) == rt == 8
    assert_metrics_close(mt, mj, rtol=1e-8)
    np.testing.assert_allclose(st.X.numpy(), np.asarray(sj.X), rtol=0,
                               atol=1e-8)
    _, jt = js.run_rbcd_spmd(jp, jst, js.SPMDConfig(**cfg), num_rounds=8,
                             gradnorm_tol=0.0, check_every=4)
    _, tt = ts.run_rbcd_spmd(tp, tst, ts.SPMDConfig(**cfg), num_rounds=8,
                             gradnorm_tol=0.0, check_every=4, device="cpu",
                             selections=draws)
    np.testing.assert_allclose(tt["cost"], jt["cost"], rtol=1e-8)
    np.testing.assert_allclose(tt["gradnorm"], jt["gradnorm"], rtol=1e-8)
    # the two-phase run function in float64 is the plain one
    st2, mt2, _ = ts.make_two_phase_run_fn(
        tp, ts.SPMDConfig(**cfg), device="cpu", selections=draws)(tst, 8, 0.0)
    assert torch.equal(st2.X, st.X)


@pytest.mark.parametrize("mode", ["uniform", "async"])
def test_own_draw_depends_on_seed_and_round_only(mode):
    """Without injection the port draws from a torch.Generator seeded with
    (cfg.seed, round counter): one run of eight rounds, eight single steps and
    (async) two runs of four give the same bits; another seed gives another
    sequence; the selections stay in range."""
    _, tp, _, _, _, tst, _ = team("grid125")
    kw = dict(BASE, mode=mode, acceleration=False)

    def run(seed, chunks):
        cfg = ts.SPMDConfig(seed=seed, **kw)
        st = tst
        for c in chunks:
            st, m, _ = ts.make_run_fn(tp, cfg, device="cpu")(st, c, 0.0)
        return st

    a = run(0, [8])
    if mode == "async":
        # (in 'uniform' every run call starts at agent 0, as in the JAX
        # package, so only the step-by-step form below carries over)
        assert torch.equal(a.X, run(0, [4, 4]).X)
    step = ts.make_step_fn(tp, ts.SPMDConfig(seed=0, **kw), device="cpu")
    st, sel, sels = tst, ts._first_selection(ts.SPMDConfig(**kw)), []
    for _ in range(8):
        st, _, sel = step(st, sel)
        sels.append(sel)
    assert torch.equal(a.X, st.X)
    assert not torch.equal(a.X, run(1, [8]).X)
    if mode == "uniform":
        assert all(0 <= s < 4 for s in sels) and len(set(sels)) > 1
        cfg = ts.SPMDConfig(seed=0, **kw)
        g = torch.zeros(4)
        assert sels == [ts._select_next(g, cfg, it) for it in range(8)]
    else:
        assert sels == [-1] * 8
        cfg = ts.SPMDConfig(seed=0, **kw)
        fires = torch.stack([ts._async_fire(cfg, it, 4, None, "cpu")
                             for it in range(200)])
        p = 1 - np.exp(-0.7)
        assert abs(float(fires.double().mean()) - p) < 0.06
        assert torch.equal(fires[7], ts._async_fire(cfg, 7, 4, None, "cpu"))


def test_async_with_acceleration_raises():
    _, tp, _, _, _, _, _ = team("grid125")
    with pytest.raises(ValueError, match="async"):
        ts.make_step_fn(tp, ts.SPMDConfig(mode="async"), device="cpu")
    with pytest.raises(ValueError, match="async"):
        ts.make_run_fn(tp, ts.SPMDConfig(mode="async", acceleration=True),
                       device="cpu")
    with pytest.raises(ValueError, match="mask"):
        ts.make_step_fn(tp, ts.SPMDConfig(mode="async", acceleration=False),
                        device="cpu", selections=[[True, False]])(
            team("grid125")[5], -1)


def test_config_defaults_match_jax():
    """Every field the port's SPMDConfig has carries the JAX default."""
    j, t = js.SPMDConfig(), ts.SPMDConfig()
    for k, v in vars(t).items():
        assert getattr(j, k) == v, k
    assert {"async_rate", "seed", "rtr_residual_control"} <= set(vars(t))


@pytest.mark.parametrize("kw", [
    dict(acceleration=False),
    dict(acceleration=True, adaptive_restart=True),
    dict(acceleration=False, mode="greedy"),
    dict(acceleration=False, rtr_inner_dtype="float32"),
])
def test_residual_control_rounds_match_jax(kw):
    """rtr_residual_control: the round rebuilds the residual data from the
    exchanged neighbor poses beside G. Three float64 rounds agree as the
    matvec-control rounds do; with a float32 tCG and control, to 1e-5."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    cfg = dict(dict(BASE, mode="all", rtr_residual_control=True), **kw)
    jstep = js.make_step_fn(jp, js.SPMDConfig(**cfg))
    tstep = ts.make_step_fn(tp, ts.SPMDConfig(**cfg), device="cpu")
    first = 0 if cfg["mode"] == "greedy" else -1
    sj, st, selj, selt = jst, tst, jnp.asarray(first, jnp.int32), first
    mixed = "rtr_inner_dtype" in kw
    for _ in range(3):
        sj, mj, selj = jstep(sj, selj)
        st, mt, selt = tstep(st, selt)
        assert int(selj) == selt
        if mixed:
            assert_state_close(st, sj, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(float(mt.cost), float(mj.cost),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(mt.gradnorm),
                                       float(mj.gradnorm), rtol=1e-3)
        else:
            assert_state_close(st, sj)
            assert_metrics_close(mt, mj)
