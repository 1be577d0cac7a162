"""Checkpoints of the SPMD optimizer state: save_state and load_state of
both packages share one .npz layout, so a checkpoint written by either loads
in the other, and a resumed run continues with the same bits as an unbroken
one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.parallel import spmd as js
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_spmd import assert_metrics_close, assert_state_close, team

CFG = dict(mode="all", acceleration=True, rtr_iterations=1,
           rtr_gradnorm_tol=1e-3, adaptive_restart=True, nesterov_n=5)


def _advanced(rounds=3):
    """Both packages' states after `rounds` accelerated rounds (gamma, Y, V,
    cost_X and the counter all set)."""
    jp, tp, _, _, jst, tst, _ = team("grid125")
    sj, _, _ = js.make_run_fn(jp, js.SPMDConfig(**CFG))(jst, rounds, 0.0)
    st, _, _ = ts.make_run_fn(tp, ts.SPMDConfig(**CFG), device="cpu")(
        tst, rounds, 0.0)
    return jp, tp, sj, st


def test_round_trip_resumes_with_the_same_bits(tmp_path):
    _, tp, _, st = _advanced()
    path = str(tmp_path / "state.npz")
    ts.save_state(st, path)
    back = ts.load_state(path, device="cpu")
    for k, a in st._asdict().items():
        b = getattr(back, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    run = ts.make_run_fn(tp, ts.SPMDConfig(**CFG), device="cpu")
    s1, m1, _ = run(st, 2, 0.0)
    s2, m2, _ = run(back, 2, 0.0)
    assert torch.equal(s1.X, s2.X) and torch.equal(s1.V, s2.V)
    assert float(m1.cost) == float(m2.cost)
    assert float(m1.gradnorm) == float(m2.gradnorm)


def test_round_trip_keeps_the_randomized_modes_on_their_draws(tmp_path):
    """The round counter travels with the checkpoint, so a resumed 'async'
    run draws what the unbroken run draws."""
    _, tp, _, _, _, tst, _ = team("grid125")
    cfg = ts.SPMDConfig(mode="async", acceleration=False, rtr_iterations=1)
    run = ts.make_run_fn(tp, cfg, device="cpu")
    whole, _, _ = run(tst, 6, 0.0)
    half, _, _ = run(tst, 3, 0.0)
    path = str(tmp_path / "half.npz")
    ts.save_state(half, path)
    resumed, _, _ = run(ts.load_state(path, device="cpu"), 3, 0.0)
    assert int(resumed.it) == 6 and torch.equal(resumed.X, whole.X)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jp, tp, sj, _ = _advanced()
    path = str(tmp_path / "jax.npz")
    js.save_state(sj, path)
    st = ts.load_state(path, device="cpu")
    assert st.X.dtype == torch.float64 and st.it.dtype == torch.int64
    assert st.do_restart.dtype == torch.bool
    assert_state_close(st, sj, atol=0.0, rtol=0.0)
    # and both continue alike from it
    s2j, mj, _ = js.make_run_fn(jp, js.SPMDConfig(**CFG))(sj, 2, 0.0)
    s2t, mt, _ = ts.make_run_fn(tp, ts.SPMDConfig(**CFG), device="cpu")(
        st, 2, 0.0)
    assert_state_close(s2t, s2j)
    assert_metrics_close(mt, mj)


def test_port_checkpoint_loads_in_jax(tmp_path):
    jp, tp, sj, st = _advanced()
    path = str(tmp_path / "torch.npz")
    ts.save_state(st, path)
    z = np.load(path)
    ref = str(tmp_path / "jax.npz")
    js.save_state(sj, ref)
    zj = np.load(ref)
    assert sorted(z.files) == sorted(zj.files)
    for k in z.files:
        assert z[k].dtype == zj[k].dtype and z[k].shape == zj[k].shape, k
    back = js.load_state(path)
    assert_state_close(st, back, atol=0.0, rtol=0.0)
    s2j, mj, _ = js.make_run_fn(jp, js.SPMDConfig(**CFG))(back, 2, 0.0)
    s2t, mt, _ = ts.make_run_fn(tp, ts.SPMDConfig(**CFG), device="cpu")(
        st, 2, 0.0)
    assert_state_close(s2t, s2j)
    assert_metrics_close(mt, mj)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_old_checkpoint_without_cost_x(tmp_path, dtype):
    """A checkpoint from before cost_X and do_restart existed: they load as
    inf and False, in X's dtype, as in the JAX package."""
    _, _, _, st = _advanced(rounds=1)
    path = str(tmp_path / "old.npz")
    np.savez(path, X=st.X.numpy().astype(dtype), Y=st.Y.numpy().astype(dtype),
             V=st.V.numpy().astype(dtype),
             gamma=st.gamma.numpy().astype(dtype),
             it=st.it.numpy().astype(np.int32))
    back = ts.load_state(path, device="cpu")
    ref = js.load_state(path)
    assert back.X.dtype == back.cost_X.dtype == back.gamma.dtype == \
        getattr(torch, np.dtype(dtype).name)
    assert float(back.cost_X) == float(ref.cost_X) == float("inf")
    assert bool(back.do_restart) is bool(ref.do_restart) is False
    assert int(back.it) == int(ref.it) == 1
    np.testing.assert_array_equal(back.X.numpy(), np.asarray(ref.X))
