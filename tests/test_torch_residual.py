"""The residual form of the objective (quadratic.build_residual_data,
cost_grad_residual) and the trust-region solver's residual-form control, in
both packages.

Float64 values agree with the JAX package's and with the matvec form to
1e-12 relative (the cost up to the documented constant); float32 near an
optimum is held to the bound of the JAX package's own test; rtr_solve with
residual_control follows the JAX trajectory (same RTR and tCG counts, cost
to 1e-9), and a batch of agents solves each agent as it would be solved
alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu import quadratic as jq
from dpgo_tpu.measurements import homogeneous
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.solvers import chordal as jc
from dpgo_tpu.solvers import rtr as jr
from dpgo_tpu.types import PRIOR_KAPPA, PRIOR_TAU
from dpgo_tpu_torch import convert
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.parallel import spmd as ts
from dpgo_tpu_torch.solvers import rtr as tr

from tests.test_torch_quadratic import _close, _fields, _meta
from tests.test_torch_spmd import team

R = 5


def _shared_prior_problem(seed=11):
    """grid3d(30) with 12 shared edges (both directions, some masked) into 6
    neighbor slots and 3 priors, in both packages, with neighbor poses."""
    rng = np.random.default_rng(seed)
    n, d, ms, npr, p = 30, 3, 12, 3, 6
    edges, _, _ = jd.synthesize_grid3d(n, seed=2)
    T = homogeneous(edges.R, edges.t)
    kw = dict(
        shared_idx=rng.integers(0, n, ms), shared_T=T[:ms],
        shared_kappa=rng.uniform(1, 100, ms), shared_tau=rng.uniform(1, 10, ms),
        shared_weight=rng.uniform(0, 1, ms),
        shared_outgoing=rng.random(ms) < 0.5,
        shared_nbr_slot=rng.integers(0, p, ms),
        shared_mask=(rng.random(ms) < 0.8).astype(float),
        prior_idx=rng.integers(0, n, npr),
        prior_pose=rng.standard_normal((npr, R, d + 1)),
        prior_mask=np.ones(npr), r=R,
    )
    jp = jq.plan_bands(jq.make_local_problem(
        n, d, edges.p1, edges.p2, T, edges.kappa, edges.tau, edges.weight,
        **kw))
    tp = convert.local_problem_from_numpy(_fields(jp), _meta(jp), device="cpu")
    nbr = rng.standard_normal((p, R, d + 1))
    Y = np.linalg.qr(rng.standard_normal((n, R, d)))[0]
    X = np.concatenate([Y, rng.standard_normal((n, R, 1))], axis=-1)
    return jp, tp, nbr, X, kw


def _private_problem(name):
    """(jax qd, port qd, lifted chordal X0) of a synthetic graph, the
    residual data attached in both."""
    edges, n = (jd.synthesize_city2d(600, seed=0) if name == "city600"
                else jd.synthesize_grid3d(125, seed=0))[:2]
    d = edges.t.shape[1]
    jp = jq.from_private_measurements(edges, n=n, d=d)
    tp = convert.local_problem_from_numpy(_fields(jp), _meta(jp), device="cpu")
    jnbr = jnp.zeros((1, R, d + 1))
    tnbr = torch.zeros((1, R, d + 1), dtype=torch.float64)
    jqd = jq.build_quadratic_data(jp, jnbr, r=R, precond="jacobi")
    jqd = dataclasses.replace(jqd, res=jq.build_residual_data(jp, jnbr))
    tqd = tq.build_quadratic_data(tp, tnbr, r=R, precond="jacobi")
    tqd = dataclasses.replace(tqd, res=tq.build_residual_data(tp, tnbr))
    T = np.asarray(jc.chordal_initialization_arrays(edges, n=n))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, R)), T)
    return jqd, tqd, X0


def test_residual_data_matches_jax():
    jp, tp, nbr, _, _ = _shared_prior_problem()
    jrd = jq.build_residual_data(jp, jnp.asarray(nbr))
    trd = tq.build_residual_data(tp, torch.as_tensor(nbr))
    carried = convert.residual_data_from_numpy(_fields(jrd), device="cpu")
    for f in dataclasses.fields(trd):
        ref = np.asarray(getattr(jrd, f.name))
        for rd in (trd, carried):
            got = getattr(rd, f.name)
            assert got.shape == ref.shape, f.name
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=0,
                                       err_msg=f.name)
    # .to() casts the floating fields and leaves the index and bool ones
    r32 = trd.to(torch.float32)
    assert r32.priv_T.dtype == r32.nbr.dtype == torch.float32
    assert r32.priv_i.dtype == torch.int64
    assert r32.shared_outgoing.dtype == torch.bool
    qd = tq.build_quadratic_data(tp, torch.as_tensor(nbr), r=R)
    qd32 = dataclasses.replace(qd, res=trd).to(torch.float32)
    assert qd32.res.prior_om.dtype == torch.float32 and qd.res is None
    from dpgo_tpu_torch import devices

    moved = devices.move(qd32, "cpu")  # the residual data moves with it
    assert torch.equal(moved.res.nbr, qd32.res.nbr)


def test_residual_form_matches_jax_and_matvec_form():
    """cost_grad_residual equals the JAX package's (1e-12) and the matvec
    form's (cost, euc_grad) up to the documented constant offset
    0.5 sum_shared ||X_nbr||^2_om + 0.5 sum_priors ||P||^2_om, on a problem
    with private and shared edges and priors."""
    jp, tp, nbr, X, kw = _shared_prior_problem()
    jrd = jq.build_residual_data(jp, jnp.asarray(nbr))
    trd = tq.build_residual_data(tp, torch.as_tensor(nbr))
    jf, jg = jq.cost_grad_residual(jrd, jnp.asarray(X))
    tf, tg = tq.cost_grad_residual(trd, torch.as_tensor(X))
    assert tf.shape == () and tg.shape == X.shape
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    _close(tg, jg)
    qd = tq.build_quadratic_data(tp, torch.as_tensor(nbr), r=R)
    _close(tg, tq.euc_grad(qd, torch.as_tensor(X)).numpy(), rtol=1e-11)
    # the constant: outgoing edges see the neighbor pose as it is, incoming
    # ones transformed by T; masked edges drop out
    d = 3
    const = 0.0
    for e in range(len(kw["shared_idx"])):
        w = kw["shared_weight"][e] * kw["shared_mask"][e]
        om = np.array([w * kw["shared_kappa"][e]] * d + [w * kw["shared_tau"][e]])
        P = nbr[kw["shared_nbr_slot"][e]]
        if not kw["shared_outgoing"][e]:
            P = P @ kw["shared_T"][e]
        const += 0.5 * np.sum(om[None, :] * P**2)
    om_p = np.array([PRIOR_KAPPA] * d + [PRIOR_TAU])
    const += 0.5 * np.sum(om_p[None, None, :] * kw["prior_pose"] ** 2)
    f_mv = float(tq.cost(qd, torch.as_tensor(X)))
    np.testing.assert_allclose(float(tf), f_mv + const, rtol=1e-12)


def test_residual_form_f32_accuracy_near_optimum():
    """The world of the JAX package's own test (200 poses, 40 loop closures,
    a float64 solve to 1e-8 from the lifted ground truth): near a minimizer
    the float32 residual-form gradient is at least as accurate as the
    float32 matvec form (err_res <= 1.2 err_mv, both dominated by the
    quantization of the evaluation point) and within 1e-4 of the float64
    gradient in norm, the bounds of that test; the two packages' float32
    residual gradients agree to 1e-5."""
    from dpgo_tpu.measurements import EdgeArrays
    from tests import oracle

    rng = np.random.default_rng(20)
    n, d = 200, 3
    meas, (Rw, tw) = oracle.random_measurements(rng, n, d, 40)
    jp = jq.from_private_measurements(EdgeArrays.from_measurements(meas),
                                      n=n, d=d)
    tp = convert.local_problem_from_numpy(_fields(jp), _meta(jp), device="cpu")
    tnbr = torch.zeros((1, R, d + 1), dtype=torch.float64)
    tqd = tq.build_quadratic_data(tp, tnbr, r=R)
    trd = tq.build_residual_data(tp, tnbr)
    T_true = np.concatenate([np.stack(Rw), np.stack(tw)[:, :, None]], axis=2)
    X0 = np.einsum("rd,nde->nre",
                   np.asarray(jl.fixed_stiefel_variable(d, R)), T_true)
    X, st = tr.rtr_solve(tqd, torch.as_tensor(X0), gradnorm_tol=1e-8,
                         initial_radius=100.0, max_iterations=50)
    assert float(st.gnorm_opt) < 1e-8
    g64 = tq.euc_grad(tqd, X).numpy()
    X32 = X.to(torch.float32)
    _, g_res = tq.cost_grad_residual(trd.to(torch.float32), X32)
    q32 = tqd.to(torch.float32)
    g_mv = tq.q_matvec(q32, X32) + q32.G
    assert g_res.dtype == torch.float32
    err_res = np.linalg.norm(g_res.double().numpy() - g64)
    err_mv = np.linalg.norm(g_mv.double().numpy() - g64)
    assert err_res <= 1.2 * err_mv, (err_res, err_mv)
    assert err_res < 1e-4
    cast = lambda x: (x.astype(jnp.float32)  # noqa: E731
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)
    jrd = jq.build_residual_data(jp, jnp.zeros((1, R, d + 1)))
    _, jg = jq.cost_grad_residual(
        jax.tree.map(cast, jrd), jnp.asarray(X.numpy(), jnp.float32),
        precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(g_res.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["city600", "grid125"])
def test_rtr_residual_control_follows_the_jax_trajectory(name):
    """Float64 rtr_solve under residual_control: the same RTR and tCG counts
    as the JAX package, cost within 1e-9, and (no shared edges, no priors:
    the constant is 0) the same cost as the matvec form at the iterate."""
    jqd, tqd, X0 = _private_problem(name)
    solve = dict(gradnorm_tol=1e-4, initial_radius=100.0, max_iterations=100,
                 max_inner=200, residual_control=True)
    jX, js = jr.rtr_solve(jqd, jnp.asarray(X0), **solve)
    X, st = tr.rtr_solve(tqd, torch.as_tensor(X0), **solve)
    assert st.iterations == int(js.iterations)
    assert int(st.tcg_iters) == int(js.tcg_iters)
    np.testing.assert_allclose(float(st.f_opt), float(js.f_opt), rtol=1e-9)
    np.testing.assert_allclose(float(st.f_init), float(js.f_init), rtol=1e-12)
    np.testing.assert_allclose(float(st.gnorm_init), float(js.gnorm_init),
                               rtol=1e-10)
    np.testing.assert_allclose(float(tq.cost(tqd, X)), float(st.f_opt),
                               rtol=1e-9)
    assert float(tq.rie_grad_norm(tqd, X)) < 1e-4
    tf, tg = tr.initial_cost_gradnorm(tqd, torch.as_tensor(X0),
                                      residual_control=True)
    jf, jg = jr.initial_cost_gradnorm(jqd, jnp.asarray(X0),
                                      residual_control=True)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-10)


def test_rtr_residual_control_mixed_precision():
    """Float32 tCG and float32 residual-form control (inner_dtype=float32):
    both packages reach the tolerance, confirmed by the float64 matvec
    form, at the same float64 cost to 1e-6; shrink_until_accept too."""
    jqd, tqd, X0 = _private_problem("city600")
    solve = dict(gradnorm_tol=1e-2, initial_radius=100.0, max_iterations=100,
                 max_inner=200, residual_control=True)
    jX, js = jr.rtr_solve(jqd, jnp.asarray(X0), inner_dtype=jnp.float32,
                          **solve)
    X, st = tr.rtr_solve(tqd, torch.as_tensor(X0), inner_dtype=torch.float32,
                         **solve)
    assert X.dtype == torch.float64
    assert float(st.gnorm_opt) < 1e-2 and float(js.gnorm_opt) < 1e-2
    assert float(tq.rie_grad_norm(tqd, X)) < 1e-2
    f_jax = float(tq.cost(tqd, torch.as_tensor(np.asarray(jX))))
    np.testing.assert_allclose(float(tq.cost(tqd, X)), f_jax, rtol=1e-6)
    one = dict(gradnorm_tol=1e-6, initial_radius=100.0, max_iterations=1,
               max_inner=3, shrink_until_accept=True, residual_control=True)
    jX, js = jr.rtr_solve(jqd, jnp.asarray(X0), **one)
    X, st = tr.rtr_solve(tqd, torch.as_tensor(X0), **one)
    assert int(st.tcg_iters) == int(js.tcg_iters)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-9)


def test_rtr_residual_control_with_shared_edges_and_priors():
    jp, tp, nbr, X, _ = _shared_prior_problem()
    jqd = jq.build_quadratic_data(jp, jnp.asarray(nbr), r=R)
    jqd = dataclasses.replace(
        jqd, res=jq.build_residual_data(jp, jnp.asarray(nbr)))
    tqd = tq.build_quadratic_data(tp, torch.as_tensor(nbr), r=R)
    tqd = dataclasses.replace(
        tqd, res=tq.build_residual_data(tp, torch.as_tensor(nbr)))
    solve = dict(gradnorm_tol=1e-6, initial_radius=100.0, max_iterations=30,
                 max_inner=50, residual_control=True)
    jX, js = jr.rtr_solve(jqd, jnp.asarray(X), **solve)
    tX, st = tr.rtr_solve(tqd, torch.as_tensor(X), **solve)
    assert st.iterations == int(js.iterations)
    assert int(st.tcg_iters) == int(js.tcg_iters)
    np.testing.assert_allclose(float(st.f_opt), float(js.f_opt), rtol=1e-9)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-7)


def test_residual_control_needs_the_residual_data():
    _, tqd, X0 = _private_problem("grid125")
    with pytest.raises(ValueError, match="build_residual_data"):
        tr.rtr_solve(dataclasses.replace(tqd, res=None), torch.as_tensor(X0),
                     1e-2, 100.0, residual_control=True)


@pytest.mark.parametrize("shrink", [True, False])
def test_batched_residual_control_equals_each_agent_alone(shrink):
    """The team of grid3d(125) in 4 agents, stacked: residual-form cost and
    gradient per agent, and rtr_solve under residual_control, equal each
    agent's own (its one-agent stack) to 1e-12, tCG counts included."""
    _, tp, _, _, _, tst, _ = team("grid125")
    cfg = ts.SPMDConfig(acceleration=False, rtr_residual_control=True,
                        precond="jacobi")
    teams = ts._Teams(tp, cfg, None)
    nbr = ts._gather_pub(tst.X, tp.pub_idx)[tp.shared_nbr_robot,
                                            tp.shared_nbr_slot]
    qd, _ = ts._with_linear_term(teams.all, nbr, True)
    assert qd.res is not None
    f_all, g_all = tq.cost_grad_residual(qd.res, tst.X)
    assert f_all.shape == (4,)
    solve = dict(gradnorm_tol=1e-6, initial_radius=100.0,
                 max_iterations=1 if shrink else 3, max_inner=10,
                 shrink_until_accept=shrink, residual_control=True)
    X_all, st_all = tr.rtr_solve(qd, tst.X, **solve)
    for a in range(4):
        qd_a, _ = ts._with_linear_term(teams.one(a), nbr[a:a + 1], True)
        f_a, g_a = tq.cost_grad_residual(qd_a.res, tst.X[a:a + 1])
        np.testing.assert_allclose(float(f_all[a]), float(f_a[0]), rtol=1e-12)
        np.testing.assert_allclose(g_all[a].numpy(), g_a[0].numpy(),
                                   rtol=0, atol=1e-12)
        X_a, st_a = tr.rtr_solve(qd_a, tst.X[a:a + 1], **solve)
        assert int(st_all.tcg_iters[a]) == int(st_a.tcg_iters[0])
        assert int(st_all.iterations[a]) == int(st_a.iterations[0])
        np.testing.assert_allclose(X_all[a].numpy(), X_a[0].numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(float(st_all.f_opt[a]),
                                   float(st_a.f_opt[0]), rtol=1e-12)
