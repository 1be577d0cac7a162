"""Parity of dpgo_tpu_torch.ops.block_tridiag with the JAX package: cyclic
reduction (factorize / solve), the RCM banded plan (identical arrays), the
banded factor and its solve, and the stacked per-agent variants, all
float64 within 1e-12 relative. The preconditioners build_q_data makes from
them: tests/test_torch_precond.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import quadratic as jq
from dpgo_tpu.ops import block_tridiag as jb
from dpgo_tpu_torch.ops import block_tridiag as tb

from tests.test_torch_quadratic import _close, _problems
from tests.test_torch_spmd import team

RTOL = 1e-12


def _spd_chain(rng, batch, n, b):
    A = rng.standard_normal(batch + (n, b, b))
    D = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(b)
    E = 0.4 * rng.standard_normal(batch + (max(n - 1, 0), b, b))
    return D, E


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 33])
def test_cyclic_reduction_matches_jax(n):
    rng = np.random.default_rng(n)
    D, E = _spd_chain(rng, (), n, 4)
    rhs = rng.standard_normal((n, 4, 3))
    ref = jb.solve(jb.factorize(jnp.asarray(D), jnp.asarray(E)),
                   jnp.asarray(rhs))
    fac = tb.factorize(torch.as_tensor(D), torch.as_tensor(E))
    assert fac.n == n and len(fac.levels) == int(np.ceil(np.log2(n)))
    _close(tb.solve(fac, torch.as_tensor(rhs)), ref)
    # a batch of independent chains: each its own solve
    Db, Eb = _spd_chain(rng, (3,), n, 4)
    rb = rng.standard_normal((3, n, 4, 2))
    fb = tb.factorize(torch.as_tensor(Db), torch.as_tensor(Eb))
    xb = tb.solve(fb, torch.as_tensor(rb))
    for a in range(3):
        ref = jb.solve(jb.factorize(jnp.asarray(Db[a]), jnp.asarray(Eb[a])),
                       jnp.asarray(rb[a]))
        _close(xb[a], ref)
        _close(tb.solve(fb.take(a), torch.as_tensor(rb[a])), ref)


def _edge_blocks(jp):
    om = np.asarray(jq._omega(jp.priv_kappa, jp.priv_tau, jp.priv_weight, jp.d))
    return np.asarray(jp.priv_T) * om[:, None, :]


@pytest.mark.parametrize("name,s", [("grid125", None), ("city600", None),
                                    ("grid125", 16)])
def test_banded_plan_and_factor_match_jax(name, s):
    """s=16 on grid125 (bandwidth 27) drops the edges that span two
    superblocks in both packages: the plan is still identical."""
    jp, _, n, d = _problems(name)
    i, j = np.asarray(jp.priv_i), np.asarray(jp.priv_j)
    pj = jb.make_banded_plan(i, j, n, d + 1, s=s)
    pt = tb.make_banded_plan(i, j, n, d + 1, s=s)
    for f in pj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert (pt.dropped > 0) == (s is not None)
    qd = jq.build_q_data(jp, r=5)
    shifted = np.asarray(qd.diag) + 0.1 * np.eye(d + 1)
    E = _edge_blocks(jp)
    bj = jb.build_banded_factor(pj, jnp.asarray(shifted), jnp.asarray(E))
    bt = tb.build_banded_factor(pt, torch.as_tensor(shifted), torch.as_tensor(E))
    V = np.random.default_rng(1).standard_normal((n, 5, d + 1))
    _close(tb.solve_banded(bt, torch.as_tensor(V)),
           jb.solve_banded(bj, jnp.asarray(V)))
    assert tb.make_banded_plan(i, j, n, d + 1, max_block=8) is None


def test_stacked_banded_factor_matches_jax():
    """The SPMD team's per-agent plans at a common s, the batched factor,
    and each agent's solve."""
    jp, tp, *_ = team("grid125")
    i, j = np.asarray(jp.priv_i), np.asarray(jp.priv_j)
    sj = jb.make_banded_plans_stacked(i, j, jp.n_max, jp.d + 1)
    st = tb.make_banded_plans_stacked(i, j, jp.n_max, jp.d + 1)
    assert (st.s, st.nb, st.n, st.dh) == (sj.s, sj.nb, sj.n, sj.dh)
    for f in ("pad_diag",) + tb._STACKED_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f),
                                      err_msg=f)
    rng = np.random.default_rng(2)
    A, n, dh = jp.num_agents, jp.n_max, jp.d + 1
    M = rng.standard_normal((A, n, dh, dh))
    shifted = M @ np.swapaxes(M, -1, -2) + 10.0 * np.eye(dh)
    om = np.abs(rng.standard_normal(np.asarray(jp.priv_kappa).shape + (dh,)))
    E = np.asarray(jp.priv_T) * om[..., None, :]
    bj = jb.build_banded_factor_stacked(sj, jnp.asarray(shifted), jnp.asarray(E))
    bt = tb.build_banded_factor_stacked(st, torch.as_tensor(shifted),
                                        torch.as_tensor(E))
    V = rng.standard_normal((A, n, 5, dh))
    x = tb.solve_banded(bt, torch.as_tensor(V))
    # the same rows flattened to (A*n, r, dh) solve the same systems
    _close(tb.solve_banded(bt, torch.as_tensor(V.reshape(A * n, 5, dh))),
           x.numpy().reshape(A * n, 5, dh))
    for a in range(A):
        fa = jax_take(bj, a)
        _close(x[a], jb.solve_banded(fa, jnp.asarray(V[a])))
        _close(tb.solve_banded(bt.take(a), torch.as_tensor(V[a])),
               jb.solve_banded(fa, jnp.asarray(V[a])))


def jax_take(bf, a):
    """Agent a's BandedFactor out of the JAX package's stacked one."""
    import jax

    return jax.tree.map(lambda x: x[a], bf)
