"""The batched RTR solve that the SPMD engine runs (each agent's result its
own solve's) and rtr_solve_auto (a block-Jacobi probe, then the exact banded
factor) against the JAX package: iteration counts agree exactly and 2f to
1e-10 (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import quadratic as jq
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.solvers import chordal as jc
from dpgo_tpu.solvers import rtr as jr
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.parallel import spmd as ts
from dpgo_tpu_torch.solvers import rtr as tr

from tests.test_torch_slice import _graphs
from tests.test_torch_spmd import team
from tests.test_torch_spmd_run import CFG


@pytest.mark.parametrize("precond", ["banded", "tridiag", "jacobi"])
def test_batched_solve_is_each_agents_own_solve(precond):
    """The batched RTR solve of the whole team gives each agent exactly its
    own solve (its one-agent team solved alone): per-agent tCG counts,
    shrinks and iterates."""
    _, tp, _, _, _, tst, _ = team("grid125")
    cfg = ts.SPMDConfig(**dict(CFG, precond=precond))
    splan = ts._plan_banded_static(tp, cfg)
    teams = ts._Teams(tp, cfg, splan)
    nbr = ts._gather_pub(tst.X, tp.pub_idx)[tp.shared_nbr_robot,
                                            tp.shared_nbr_slot]
    kw = dict(gradnorm_tol=1e-4, initial_radius=100.0, max_inner=50)
    for shrink, iters in ((True, 1), (False, 3)):
        X, st = tr.rtr_solve(ts._with_linear_term(teams.all, nbr)[0], tst.X,
                             max_iterations=iters, shrink_until_accept=shrink,
                             **kw)
        assert st.tcg_iters.shape == (tp.num_agents,)
        for a in range(tp.num_agents):
            Xa, sa = tr.rtr_solve(
                ts._with_linear_term(teams.one(a), nbr[a:a + 1])[0],
                tst.X[a:a + 1], max_iterations=iters,
                shrink_until_accept=shrink, **kw)
            assert int(sa.tcg_iters[0]) == int(st.tcg_iters[a])
            assert int(sa.iterations[0]) == int(st.iterations[a])
            np.testing.assert_allclose(X[a].numpy(), Xa[0].numpy(), rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(float(st.f_opt[a]), float(sa.f_opt[0]),
                                       rtol=1e-12)


def _spy_phases(monkeypatch):
    """Each phase of rtr_solve_auto as (preconditioner, data, stats)."""
    phases = []
    build, solve = tq.build_quadratic_data, tr.rtr_solve

    def spy_build(*a, **kw):
        phases.append([kw["precond"]])
        return build(*a, **kw)

    def spy_solve(qd, *a, **kw):
        out = solve(qd, *a, **kw)
        phases[-1] += [qd, out[1]]
        return out

    monkeypatch.setattr(tq, "build_quadratic_data", spy_build)
    monkeypatch.setattr(tr, "rtr_solve", spy_solve)
    return phases


@pytest.mark.parametrize("name,inner", [("grid125", None), ("city600", None),
                                        ("grid125", "float32")])
def test_rtr_solve_auto_matches_jax(name, inner, monkeypatch):
    """A one-iteration block-Jacobi probe, then the escalation to the exact
    banded factor: the same iteration counts, 2f within 1e-10 (float64) or
    1e-8 (float32 tCG)."""
    (je, n), (te, _), d = _graphs(name)
    r = 5
    jp = jq.from_private_measurements(je, n=n, d=d)
    tp = tq.from_private_measurements(te, n=n, d=d, device="cpu")
    T = np.asarray(jc.chordal_initialization_arrays(je, n=n))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, r)), T)
    kw = dict(gradnorm_tol=1e-6, initial_radius=100.0, max_iterations=30,
              max_inner=200, probe_iterations=1)
    jX, js_ = jr.rtr_solve_auto(
        jp, jnp.asarray(X0), inner_dtype=jnp.float32 if inner else None, **kw)
    phases = _spy_phases(monkeypatch)
    tX, ts_ = tr.rtr_solve_auto(
        tp, torch.as_tensor(X0), inner_dtype=torch.float32 if inner else None,
        device="cpu", **kw)
    assert [p[0] for p in phases] == ["jacobi", "banded"]
    assert phases[0][2].iterations == 1
    assert phases[1][1].btf is not None
    assert ts_.iterations == int(js_.iterations)
    assert int(ts_.tcg_iters) == int(js_.tcg_iters)
    np.testing.assert_allclose(2 * float(ts_.f_opt), 2 * float(js_.f_opt),
                               rtol=1e-8 if inner else 1e-10)
    assert float(ts_.gnorm_opt) < 1e-6


def test_rtr_solve_auto_stops_after_a_converged_probe(monkeypatch):
    (je, n), (te, _), d = _graphs("grid125")
    tp = tq.from_private_measurements(te, n=n, d=d, device="cpu")
    T = np.asarray(jc.chordal_initialization_arrays(je, n=n))
    X0 = torch.as_tensor(np.einsum(
        "rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, 5)), T))
    phases = _spy_phases(monkeypatch)
    _, st = tr.rtr_solve_auto(tp, X0, gradnorm_tol=1e-2, probe_iterations=15,
                              device="cpu")
    assert [p[0] for p in phases] == ["jacobi"]
    assert float(st.gnorm_opt) < 1e-2
