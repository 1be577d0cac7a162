"""The RTR solver's other modes and entry points in both packages: the
per-RBCD-step shrink-until-accept mode with the masked-unroll tCG, the
initial cost and gradnorm, and the solve_pgo quick start. Inputs come from
the synthesizers at small sizes; costs are f = 0.5 <XQ, X> + <X, G>."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpgo_tpu
from dpgo_tpu import quadratic as jq
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.solvers import chordal as jc
from dpgo_tpu.solvers import rtr as jr
from dpgo_tpu.types import ROptParameters as JParams
import dpgo_tpu_torch
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.solvers import rtr as tr
from dpgo_tpu_torch.types import ROptMethod, ROptParameters

from tests.test_torch_slice import _graphs, _jax_slice, _torch_slice


@pytest.mark.parametrize("max_inner", [1, 3])
def test_shrink_until_accept_and_unrolled_tcg(max_inner):
    """The per-RBCD-step mode with a small tCG cap: the masked-unroll tCG
    (no host sync) matches the while form and the JAX package."""
    (je, n), (te, _), d = _graphs("city600")
    solve = dict(gradnorm_tol=1e-6, initial_radius=100.0, max_iterations=1,
                 max_inner=max_inner, shrink_until_accept=True)
    jX, js = _jax_slice(je, n, d, 5, mixed=False, **solve)
    X_unroll, ts, _ = _torch_slice(te, n, d, 5, mixed=False, **solve)
    X_loop, ts_loop, _ = _torch_slice(te, n, d, 5, mixed=False, tcg_unroll=0,
                                      **solve)
    assert int(ts.tcg_iters) == int(ts_loop.tcg_iters) == int(js.tcg_iters)
    assert ts.iterations == ts_loop.iterations == int(js.iterations)
    np.testing.assert_allclose(X_unroll.numpy(), X_loop.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(X_unroll.numpy(), np.asarray(jX), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(ts.f_opt), float(js.f_opt), rtol=1e-10)


def test_initial_cost_gradnorm_matches_jax():
    (je, n), (te, _), d = _graphs("grid125")
    jp = jq.from_private_measurements(je, n=n, d=d)
    tp = tq.from_private_measurements(te, n=n, d=d, device="cpu")
    T = np.asarray(jc.chordal_initialization_arrays(je, n=n))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, 5)), T)
    jf, jg = jr.initial_cost_gradnorm(
        jq.build_quadratic_data(jp, jnp.zeros((1, 5, d + 1)), r=5),
        jnp.asarray(X0))
    tf, tg = tr.initial_cost_gradnorm(
        tq.build_quadratic_data(tp, torch.zeros((1, 5, d + 1),
                                                dtype=torch.float64), r=5),
        torch.as_tensor(X0))
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-12)


def test_solve_pgo_quick_start_matches_jax():
    """The README quick start at rank r = d: chordal init + RTR."""
    (je, n), (te, _), d = _graphs("grid125")
    params = dict(RTR_iterations=20, gradnorm_tol=1e-6)
    JT, js = dpgo_tpu.solve_pgo(je.to_measurements(), JParams(**params))
    T, ts = dpgo_tpu_torch.solve_pgo(te.to_measurements(),
                                     ROptParameters(**params), device="cpu")
    assert T.shape == (n, d, d + 1) and float(ts.gnorm_opt) < 1e-6
    assert ts.iterations == int(js.iterations)
    np.testing.assert_allclose(float(ts.f_opt), float(js.f_opt), rtol=1e-8)
    np.testing.assert_allclose(T.numpy(), np.asarray(JT), rtol=0, atol=1e-7)


def test_unported_options_raise():
    """What is still not ported raises: a device mesh. (residual_control
    and ROptMethod.RGD, which used to raise here, are ported: the first now
    only asks for the residual data.)"""
    (_, n), (te, _), d = _graphs("city600")
    problem = tq.from_private_measurements(te, n=n, d=d, device="cpu")
    qd = tq.build_quadratic_data(
        problem, torch.zeros((1, d, d + 1), dtype=torch.float64), r=d)
    X0 = torch.zeros((n, d, d + 1), dtype=torch.float64)
    with pytest.raises(ValueError):
        tr.rtr_solve(qd, X0, 1e-2, 100.0, residual_control=True)
    from dpgo_tpu_torch.parallel import spmd
    from tests.test_torch_spmd import team

    with pytest.raises(NotImplementedError):
        spmd.make_step_fn(team("grid125")[1], spmd.SPMDConfig(),
                          mesh=object(), device="cpu")


def _lifted_problem(name, r=5):
    """(jax qd, port qd, lifted chordal X0) with the block-Jacobi
    preconditioner."""
    (je, n), (te, _), d = _graphs(name)
    jp = jq.from_private_measurements(je, n=n, d=d)
    tp = tq.from_private_measurements(te, n=n, d=d, device="cpu")
    T = np.asarray(jc.chordal_initialization_arrays(je, n=n))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, r)), T)
    jqd = jq.build_quadratic_data(jp, jnp.zeros((1, r, d + 1)), r=r,
                                  precond="jacobi")
    tqd = tq.build_quadratic_data(
        tp, torch.zeros((1, r, d + 1), dtype=torch.float64), r=r,
        precond="jacobi")
    return jqd, tqd, X0


@pytest.mark.parametrize("precond", [True, False])
def test_rgd_step_matches_jax(precond):
    """One Riemannian gradient step, preconditioned or not: 1e-12."""
    jqd, tqd, X0 = _lifted_problem("grid125")
    ref = jr.rgd_step(jqd, jnp.asarray(X0), 1e-3, precond)
    got = tr.rgd_step(tqd, torch.as_tensor(X0), 1e-3, precond)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["city600", "grid125"])
def test_rsd_line_search_matches_jax(name):
    """Steepest descent with Armijo backtracking: the same iteration count,
    iterate to 1e-9 and cost to 1e-12 as the JAX package's nested
    while-loops, and the cost does not increase."""
    jqd, tqd, X0 = _lifted_problem(name)
    kw = dict(gradnorm_tol=1e-3, max_iterations=6, initial_step=0.5)
    jX, js = jr.rsd_line_search(jqd, jnp.asarray(X0), **kw)
    X, st = tr.rsd_line_search(tqd, torch.as_tensor(X0), **kw)
    assert st.iterations == int(js.iterations) == 6
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(st.f_opt), float(js.f_opt), rtol=1e-12)
    np.testing.assert_allclose(float(st.gnorm_opt), float(js.gnorm_opt),
                               rtol=1e-8)
    np.testing.assert_allclose(float(st.f_init), float(js.f_init), rtol=1e-12)
    assert float(st.f_opt) < float(st.f_init)
    # already below the tolerance: no iteration
    _, st0 = tr.rsd_line_search(tqd, X, gradnorm_tol=1e9)
    assert st0.iterations == 0


def test_optimize_rgd_matches_jax():
    """optimize's RGD branch: one step and the stats around it."""
    from dpgo_tpu.types import ROptMethod as JMethod

    jqd, tqd, X0 = _lifted_problem("city600")
    kw = dict(RGD_stepsize=2e-3, RGD_use_preconditioner=True)
    jY, js = jr.optimize(jqd, jnp.asarray(X0),
                         JParams(method=JMethod.RGD, **kw))
    Y, st = tr.optimize(tqd, torch.as_tensor(X0),
                        ROptParameters(method=ROptMethod.RGD, **kw))
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=0, atol=1e-12)
    for k in ("f_init", "gnorm_init", "f_opt", "gnorm_opt"):
        np.testing.assert_allclose(float(getattr(st, k)),
                                   float(getattr(js, k)), rtol=1e-10)
    assert st.iterations == int(js.iterations) == 1
    assert bool(st.accepted) and int(st.tcg_iters) == 0
    assert float(st.f_opt) < float(st.f_init)


@pytest.mark.parametrize(
    "flags",
    [{"inner_control_matvecs": True},
     {"exact_inner_hessian": False},
     {"inner_control_matvecs": True, "exact_inner_hessian": False}],
)
def test_mixed_precision_control_variants_match_jax(flags):
    """The mixed-precision knobs: cost decrease from inner-precision
    matvecs, and the model decrease from the inner-precision Hessian. With
    inner control matvecs f_opt is anchored at a float32 cost, so the
    iterates are compared by their float64 cost instead."""
    (je, n), (te, _), d = _graphs("city600")
    solve = dict(gradnorm_tol=1e-2, initial_radius=100.0, max_iterations=100,
                 max_inner=200, **flags)
    jX, js = _jax_slice(je, n, d, 5, mixed=True, **solve)
    X, ts, qd = _torch_slice(te, n, d, 5, mixed=True, **solve)
    assert float(js.gnorm_opt) < 1e-2 and float(ts.gnorm_opt) < 1e-2
    f_jax = float(tq.cost(qd, torch.tensor(np.asarray(jX))))
    np.testing.assert_allclose(float(tq.cost(qd, X)), f_jax, rtol=1e-6)
