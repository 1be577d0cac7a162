"""The centralized GNC solve, solve_robust_pgo, in both packages: the
4-pose world of tests/test_pgo.py (odometry with fixed weights, one inlier
and one garbage loop closure) and synthesize_grid3d(64) with planted
outliers. Float64 on the CPU: the final weights agree to 1e-8 and the
trajectories to 1e-6; the squared residuals to 1e-12."""

import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu.measurements import EdgeArrays
from dpgo_tpu.solvers import pgo as jpgo
from dpgo_tpu.types import ROptParameters as JROpt
from dpgo_tpu.types import RobustCostParameters as JRobust
from dpgo_tpu.types import RobustCostType as JType
from dpgo_tpu_torch.measurements import RelativeSEMeasurement as TMeas
from dpgo_tpu_torch.solvers import pgo as tpgo
from dpgo_tpu_torch.types import (ROptParameters, RobustCostParameters,
                                  RobustCostType)

from tests.test_pgo import _four_pose_graph_with_outlier


def _port_list(meas):
    return [TMeas(m.r1, m.r2, m.p1, m.p2, m.R, m.t, m.kappa, m.tau, m.weight,
                  m.fixed_weight) for m in meas]


def _params(opt, robust):
    return (jpgo.SolveRobustPGOParams(
                opt_params=JROpt(**opt),
                robust_params=JRobust(cost_type=JType.GNC_TLS, **robust)),
            tpgo.SolveRobustPGOParams(
                opt_params=ROptParameters(**opt),
                robust_params=RobustCostParameters(
                    cost_type=RobustCostType.GNC_TLS, **robust)))


def test_residuals_sq_match_jax():
    edges, n, T_true = jd.synthesize_grid3d(64, seed=1)
    T = T_true + 0.01 * np.random.default_rng(0).standard_normal(T_true.shape)
    ref = jpgo._residuals_sq(edges, T)
    got = tpgo._residuals_sq(edges, torch.as_tensor(T))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


def test_solve_robust_pgo_rejects_outlier():
    """The world of the JAX package's test: the inlier loop closure ends at
    weight 1, the outlier at 0, the fixed odometry weights stay, and both
    packages give the same weights and trajectory."""
    meas = _four_pose_graph_with_outlier(np.random.default_rng(43))
    jparams, tparams = _params(
        dict(gradnorm_tol=1e-3, RTR_iterations=50, RTR_tCG_iterations=100),
        dict(GNC_max_iters=100))
    given = _port_list(meas)
    given[3].weight = 0.25  # the solve starts every weight at 1
    JT, jout = jpgo.solve_robust_pgo(meas, jparams)
    T, out = tpgo.solve_robust_pgo(given, tparams, device="cpu")
    assert given[3].weight == 0.25 and out is not given
    assert out[3].weight == pytest.approx(1.0, abs=1e-6)
    assert out[4].weight == pytest.approx(0.0, abs=1e-6)
    assert all(m.weight == 1.0 and m.fixed_weight for m in out[:3])
    np.testing.assert_allclose([m.weight for m in out],
                               [m.weight for m in jout], rtol=0, atol=1e-8)
    assert T.dtype == torch.float64 and T.shape == (4, 3, 4)
    np.testing.assert_allclose(T.numpy(), np.asarray(JT), rtol=0, atol=1e-6)


def test_solve_robust_pgo_planted_outliers_match_jax():
    """grid3d(64) with 15% planted outlier loop closures, default
    parameters apart from a tighter solve: the same weights as the JAX
    package, every planted edge rejected, and the loop stopped early (no
    weight undecided)."""
    edges, n, _ = jd.synthesize_grid3d(64, seed=0)
    meas, planted = jd.plant_outliers(edges.to_measurements(), n, frac=0.15,
                                      seed=1)
    jparams, tparams = _params(
        dict(gradnorm_tol=1e-6, RTR_iterations=30, RTR_tCG_iterations=100),
        dict(GNC_max_iters=60))
    _, jout = jpgo.solve_robust_pgo(meas, jparams)
    T, out = tpgo.solve_robust_pgo(_port_list(meas), tparams, device="cpu")
    w = np.array([m.weight for m in out])
    np.testing.assert_allclose(w, [m.weight for m in jout], rtol=0, atol=1e-8)
    rejected = {(m.p1, m.p2) for m in out if m.weight < 1e-8}
    assert planted <= rejected
    assert rejected == {(m.p1, m.p2) for m in jout if m.weight < 1e-8}
    assert ((w < 1e-8) | (w > 1 - 1e-8)).all()
    assert bool(torch.isfinite(T).all())


def test_solve_robust_pgo_default_parameters_and_bad_cost():
    meas = _port_list(_four_pose_graph_with_outlier(np.random.default_rng(7)))
    T, out = tpgo.solve_robust_pgo(meas, device="cpu")
    assert len(out) == len(meas) and T.shape == (4, 3, 4)
    with pytest.raises(ValueError, match="GNC_TLS"):
        tpgo.solve_robust_pgo(meas, tpgo.SolveRobustPGOParams(
            robust_params=RobustCostParameters()), device="cpu")
    assert isinstance(EdgeArrays.from_measurements(out).weight, np.ndarray)
