"""Parity of the preconditioners that dpgo_tpu_torch.quadratic.build_q_data
makes (block-Jacobi, the tridiagonal and the exact banded factor, 'auto')
with the JAX package's: the same factor kind and precond_solve within 1e-12
(float64), the fallback where the banded plan is refused, and the SPMD
engine's stacked per-agent data."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import quadratic as jq
from dpgo_tpu.ops import block_tridiag as jb
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.ops import block_tridiag as tb

from tests.test_torch_block_tridiag import jax_take
from tests.test_torch_quadratic import _close, _problems
from tests.test_torch_spmd import team


@pytest.mark.parametrize("name", ["grid125", "city600"])
@pytest.mark.parametrize("precond", ["jacobi", "tridiag", "banded", "auto"])
def test_precond_solve_matches_jax(name, precond):
    """build_q_data with each preconditioner, on concrete edge indices (the
    centralized path): the same factor kind, and precond_solve within
    1e-12."""
    jp, tp, n, d = _problems(name)
    r = 5
    jqd = jq.build_q_data(jp, r=r, precond=precond)
    tqd = tq.build_q_data(tp, r=r, precond=precond)
    kind = {type(None): None, jb.CRFactor: tb.CRFactor,
            jb.BandedFactor: tb.BandedFactor}[type(jqd.btf)]
    assert (type(tqd.btf) if tqd.btf is not None else None) is kind
    assert tqd.precond_inv.shape == jqd.precond_inv.shape
    V = np.random.default_rng(3).standard_normal((n, r, d + 1))
    _close(tq.precond_solve(tqd, torch.as_tensor(V)),
           jq.precond_solve(jqd, jnp.asarray(V)))
    # the float32 copy casts the factor too
    t32 = tqd.to(torch.float32)
    if kind is not None:
        leaves = (t32.btf.cr if kind is tb.BandedFactor else t32.btf).root_inv
        assert leaves.dtype == torch.float32
    _close(tq.precond_solve(t32, torch.as_tensor(V, dtype=torch.float32)),
           jq.precond_solve(jqd, jnp.asarray(V)), rtol=2e-5)


def test_banded_falls_back_where_the_plan_is_refused(monkeypatch):
    """With the plan refused, 'banded' falls back to tridiag for a chain of
    at most 5,000 poses, as in the JAX package."""
    monkeypatch.setattr(jb, "make_banded_plan", lambda *a, **k: None)
    monkeypatch.setattr(tb, "make_banded_plan", lambda *a, **k: None)
    jp, tp, n, d = _problems("city600")
    jqd = jq.build_q_data(jp, r=5, precond="banded")
    tqd = tq.build_q_data(tp, r=5, precond="banded")
    assert isinstance(jqd.btf, jb.CRFactor) and isinstance(tqd.btf, tb.CRFactor)
    V = np.random.default_rng(4).standard_normal((n, 5, d + 1))
    _close(tq.precond_solve(tqd, torch.as_tensor(V)),
           jq.precond_solve(jqd, jnp.asarray(V)))


def test_stacked_quadratic_data_is_each_agents_own():
    """The SPMD engine's stacked data (block_rows = n_max): q_matvec and
    precond_solve on (A, n, r, dh) give each agent's own problem's result,
    band lanes never reaching across an agent's block."""
    from dpgo_tpu.parallel import spmd as js
    from dpgo_tpu_torch.parallel import spmd as ts

    jp, tp, *_ = team("reversed")
    cfg = ts.SPMDConfig()
    teams = ts._Teams(tp, cfg, ts._plan_banded_static(tp, cfg))
    A, n, r, dh = tp.num_agents, tp.n_max, tp.r, tp.dh
    V = np.random.default_rng(5).standard_normal((A, n, r, dh))
    got_mv = tq.q_matvec(teams.all.qd, torch.as_tensor(V))
    got_pc = tq.precond_solve(teams.all.qd, torch.as_tensor(V))
    jcfg = js.SPMDConfig()
    splan, arrays = js._plan_banded_static(jp, jcfg)
    jqd = js._attach_banded_static(
        jp, js._build_qd_static(jp, dataclasses.replace(jcfg, precond="jacobi")),
        splan, arrays)
    for a in range(A):
        qa = jax_take(jqd, a)
        _close(got_mv[a], jq.q_matvec(qa, jnp.asarray(V[a])))
        _close(got_pc[a], jq.precond_solve(qa, jnp.asarray(V[a])))
