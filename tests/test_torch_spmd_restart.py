"""The SPMD engine's restart configuration in both packages: the adaptive
restart's noise margin restart_cost_rtol, and the validation of
restart_scheme and rtr_tcg_precision. Float64 rounds on
tests/test_torch_spmd.py's teams agree to 1e-9 in X, Y, V and 1e-10
relative in the metrics."""

import pytest

from dpgo_tpu.parallel import spmd as js
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_spmd import (assert_metrics_close, assert_state_close,
                                   run_steps, team)


@pytest.mark.parametrize("name,rtol", [("grid125", 1e-3), ("city600", 1e-3),
                                       ("grid125", -1e-3)])
def test_restart_cost_rtol_matches_jax(name, rtol):
    """20 accelerated float64 rounds with adaptive_restart=True and
    restart_cost_rtol=rtol: the same states and metrics as the JAX package.
    A negative margin restarts whenever a round decreases the cost by less
    than |rtol|, which changes this run (the margin-free run ends
    elsewhere)."""
    kw = dict(adaptive_restart=True, restart_interval=10**6)
    sj, mj, st, mt, _, _ = run_steps(name, rounds=20, restart_cost_rtol=rtol,
                                     **kw)
    assert_state_close(st, sj)
    assert_metrics_close(mt, mj)
    if rtol < 0:
        _, m0, _, _, _, _ = run_steps(name, rounds=20, **kw)
        assert float(m0.cost) != float(mt.cost)


@pytest.mark.parametrize("field,value", [("restart_scheme", "exct"),
                                         ("rtr_tcg_precision", "low")])
def test_unknown_restart_config_raises(field, value):
    """An unknown restart_scheme raises in both packages' step functions (a typo
    must not fall through to the 'cost' comparison); the port also refuses
    an unknown rtr_tcg_precision. The known values build."""
    jp, tp, *_ = team("grid125")
    cfg = {field: value}
    if field == "restart_scheme":
        with pytest.raises(ValueError):
            js.make_step_fn(jp, js.SPMDConfig(**cfg))
    with pytest.raises(ValueError):
        ts.make_step_fn(tp, ts.SPMDConfig(**cfg), device="cpu")
    for ok in ("cost", "exact", "gradient"):
        ts.make_step_fn(tp, ts.SPMDConfig(restart_scheme=ok), device="cpu")
    for ok in (None, "high", "highest"):
        ts.make_step_fn(tp, ts.SPMDConfig(rtr_tcg_precision=ok), device="cpu")
