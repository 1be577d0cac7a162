"""Parity of dpgo_tpu_torch.robust with dpgo_tpu.robust: the weights of every
cost type (scalar and batched), the GNC schedule and the quantile helpers.
Float64 results agree to 1e-12; the float32 clamp of gnc_tls_weights is the
port's own and is checked against its documented behaviour."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import robust as jr
from dpgo_tpu import types as jt
from dpgo_tpu_torch import robust as tr
from dpgo_tpu_torch import types as tt

RTOL = 1e-12
PARAMS = dict(GNC_barc=2.0, GNC_init_mu=0.3, GNC_mu_step=1.7,
              GNC_max_iters=3, huber_threshold=1.5, TLS_threshold=2.5)


def _costs(name):
    jc = jr.RobustCost(jt.RobustCostParameters(
        cost_type=jt.RobustCostType[name], **PARAMS))
    tc = tr.RobustCost(tt.RobustCostParameters(
        cost_type=tt.RobustCostType[name], **PARAMS))
    return jc, tc


def test_types_match_jax():
    assert [e.name for e in tt.RobustCostType] == \
        [e.name for e in jt.RobustCostType]
    assert [e.name for e in tt.InitializationMethod] == \
        [e.name for e in jt.InitializationMethod]
    assert vars(tt.RobustCostParameters()).keys() == \
        vars(jt.RobustCostParameters()).keys()
    j, t = jt.RobustCostParameters(), tt.RobustCostParameters()
    for k, v in vars(j).items():
        if k != "cost_type":
            assert getattr(t, k) == v


@pytest.mark.parametrize("name", [e.name for e in tt.RobustCostType])
def test_weights_match_jax(name):
    """Scalar and batched weights over residuals on both sides of every
    threshold, before and after two schedule updates."""
    jc, tc = _costs(name)
    r = np.random.default_rng(3).uniform(0.05, 6.0, 200)
    for _ in range(3):
        ref = np.asarray(jc.weights(jnp.asarray(r)))
        got = tc.weights(torch.as_tensor(r))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)
        np.testing.assert_allclose(tc.weights(r).numpy(), ref, rtol=RTOL)
        for x in r[:20]:
            np.testing.assert_allclose(tc.weight(float(x)),
                                       jc.weight(float(x)), rtol=RTOL)
        jc.update(), tc.update()
        assert tc.mu == jc.mu


def test_gnc_schedule_matches_jax():
    """mu grows by mu_step until GNC_max_iters updates, then stays; reset
    and set_init_mu as in the JAX package."""
    jc, tc = _costs("GNC_TLS")
    mus = []
    for _ in range(6):
        jc.update(), tc.update()
        assert tc.mu == jc.mu
        mus.append(tc.mu)
    assert mus[2] == mus[3] == mus[5]  # capped after 3 updates
    jc.reset(), tc.reset()
    assert tc.mu == jc.mu == PARAMS["GNC_init_mu"]
    jc.set_init_mu(0.9), tc.set_init_mu(0.9)
    jc.update(), tc.update()
    assert tc.mu == jc.mu
    # a non-GNC cost ignores the schedule
    _, huber = _costs("Huber")
    huber.update()
    assert huber.mu == PARAMS["GNC_init_mu"]


@pytest.mark.parametrize("mu", [1e-4, 0.5, 40.0])
def test_gnc_tls_weights_match_jax(mu):
    r_sq = np.concatenate([[0.0, 1e-320], np.random.default_rng(5).uniform(
        0, 60, 300)])
    ref = np.asarray(jr.gnc_tls_weights(jnp.asarray(r_sq), 25.0, mu))
    got = tr.gnc_tls_weights(torch.as_tensor(r_sq), 25.0, mu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)


def test_gnc_tls_weights_float32_clamp():
    """In float32 the clamp is finfo.tiny (the JAX package's 1e-300 is 0
    there): a zero residual gets weight 1 and nothing is NaN or inf."""
    r_sq = torch.tensor([0.0, 1e-45, 1e-30, 1.0, 30.0, 1e30],
                        dtype=torch.float32)
    w = tr.gnc_tls_weights(r_sq, 25.0, 0.5)
    assert w.dtype == torch.float32 and bool(torch.isfinite(w).all())
    assert w[:3].tolist() == [1.0, 1.0, 1.0] and w[-1] == 0.0
    ref = np.asarray(jr.gnc_tls_weights(
        jnp.asarray(r_sq.double().numpy()), 25.0, 0.5))
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-6)


def test_quantile_helpers_match_jax():
    for q, dof in [(0.9, 6), (0.5, 3), (0.99, 1)]:
        assert tr.chi2inv(q, dof) == jr.chi2inv(q, dof)
    for a in (0.0, 0.3, np.pi):
        np.testing.assert_allclose(tr.angular_to_chordal_so3(a),
                                   jr.angular_to_chordal_so3(a), rtol=RTOL)
    for q in (0.5, 0.9, 1.0, 2.0):
        assert tr.error_threshold_at_quantile(q, 3) == \
            jr.error_threshold_at_quantile(q, 3)
    with pytest.raises(ValueError):
        tr.error_threshold_at_quantile(0.9, 2)
    with pytest.raises(ValueError):
        tr.error_threshold_at_quantile(0.0, 3)


def test_log_is_the_ports_own():
    """The port logs under its own logger name, quiet by default."""
    from dpgo_tpu_torch import log

    assert log.logger.name == "dpgo_tpu_torch"
    log.info("quiet %s", 1)
    with pytest.raises(AssertionError, match="CHECK failed: bad 3"):
        log.check(False, "bad %d", 3)
    log.check(True)
