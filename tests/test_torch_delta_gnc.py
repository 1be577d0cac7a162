"""The delta engine's end-to-end runs against the JAX package on the CPU:
elastic membership (an inactive agent frozen bitwise), run_delta_gnc (the
same rejected set, mu within 1e-5) and run_delta_certified certifying where
the plain float32 engine is floored."""

import jax.numpy as jnp
import numpy as np
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.parallel import delta as jdm
from dpgo_tpu.parallel import spmd as js
from dpgo_tpu.solvers.pgo import chordal_initialization
from dpgo_tpu_torch import convert
from dpgo_tpu_torch import datasets as td
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.parallel import delta as tdm
from dpgo_tpu_torch.parallel import spmd as ts

from tests.test_torch_delta import R, stack, team
from tests.test_torch_delta_run import CFG, metrics_close, to_port
from tests.test_torch_spmd import jax_fields, jax_meta


def test_elastic_membership_matches_jax():
    """An agent deactivates mid-run: its point (ACC + D) stays bitwise
    frozen through rounds and a re-anchor, the team's metrics agree with
    the JAX package's, and GNC reweighting leaves the edges to the inactive
    neighbor untouched."""
    jp, tp, _, Xs, _, _ = team("grid125")
    cfg = dict(CFG, acceleration=False)
    jrun = jdm.make_delta_run_fn(jp, js.SPMDConfig(**cfg), reanchor_every=5)
    trun = tdm.make_delta_run_fn(tp, ts.SPMDConfig(**cfg), reanchor_every=5,
                                 device="cpu")
    jref = jdm.build_delta_ref(jp, Xs)
    jst, jref, _, _ = jrun(jref, jdm.initial_delta_state(jref), 4, 0.0)
    tref, tst = to_port(jref, jst)
    active = np.ones(4, bool)
    active[2] = False
    jdrop, tdrop = jp.with_robot_active(active), tp.with_robot_active(active)
    before = (tst.ACC + tst.D)[2].clone()
    jst, jref, jm, _ = jrun(jref, jst, 6, 0.0, problem=jdrop)
    tst, tref, tm, _ = trun(tref, tst, 6, 0.0, problem=tdrop)
    assert torch.equal((tst.ACC + tst.D)[2], before)
    metrics_close(tm, jm, jst)
    pw = tdm.delta_gnc_reweight(tdrop, tref, tst.D, 25.0, 1e-4)
    to_inactive = tdrop.shared_nbr_robot == 2
    assert torch.equal(pw.shared_weight[to_inactive],
                       tdrop.shared_weight[to_inactive])


def test_run_delta_gnc_matches_jax():
    """run_delta_gnc (adaptive mu0, 5 updates of 10 rounds, no
    acceleration) on city2d(600) with 15% planted outlier loop closures in
    3 agents: the same rejected set (by pair) and mu within 1e-5; every
    phase's cost within 1e-5."""
    edges, n, _ = jd.synthesize_city2d(600, seed=0)
    meas, planted = jd.plant_outliers(edges.to_measurements(), n, frac=0.15,
                                      seed=1)
    jp, ranges = js.build_spmd_problem(meas, n, 3, R, dtype=jnp.float32)
    tp = convert.spmd_problem_from_numpy(jax_fields(jp), jax_meta(jp),
                                         device="cpu", dtype=torch.float32)
    T = np.asarray(chordal_initialization(meas))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(2, R)),
                   T)
    Xs = stack(jp, ranges, X0, 2)
    cfg = dict(mode="all", acceleration=False, rtr_iterations=1)
    kw = dict(barc=5.0, num_weight_updates=5, inner_rounds=10)
    jout = jdm.run_delta_gnc(jp, Xs, js.SPMDConfig(**cfg), **kw)
    tout = tdm.run_delta_gnc(tp, Xs, ts.SPMDConfig(**cfg), device="cpu", **kw)

    def rejected(table):
        return {e["pair"] for e in table if not e["fixed"]
                and e["weight"] < 1e-6}

    rj = rejected(js.edge_weight_table(jout[0], ranges))
    rt = rejected(ts.edge_weight_table(tout[0], ranges))
    assert rt == rj and len(rt & planted) > 0
    for hj, ht in zip(jout[4], tout[4]):
        assert ht["rounds"] == hj["rounds"] == 10
        assert abs(ht["mu"] - hj["mu"]) <= 1e-5 * hj["mu"]
        assert abs(ht["cost"] - hj["cost"]) <= 1e-5 * hj["cost"]
    np.testing.assert_allclose(tout[3], jout[3], rtol=0, atol=1e-4)


def test_run_delta_certified_beats_f32_floor():
    """synthesize_grid3d(216, seed=3) shifted 30,000 units from the origin
    (a gauge translation): the plain float32 engine is floored above tol by
    the pose values' float32 resolution, while run_delta_certified from the
    same start certifies below tol in the central float64 evaluation (the
    JAX package's test_delta_engine_beats_f32_floor)."""
    edges, n, T_true = td.synthesize_grid3d(216, seed=3)
    meas = edges.to_measurements()
    N, tol = 4, 1e-2
    tp, ranges = ts.build_spmd_problem(meas, n, N, R, dtype=torch.float32,
                                       device="cpu")
    T = np.asarray(T_true).copy()
    T[:, :, 3] += 30000.0
    X0 = np.einsum("rd,nde->nre",
                   np.asarray(jl.fixed_stiefel_variable(3, R)), T)
    prob = tq.from_private_measurements(edges, n=n, d=3, device="cpu")
    qd = tq.build_quadratic_data(
        prob, torch.zeros((1, R, 4), dtype=torch.float64), r=R)

    def central_gradnorm(stacked):
        X = torch.zeros((n, R, 4), dtype=torch.float64)
        for a, (s, e) in enumerate(ranges):
            X[s:e] = torch.as_tensor(np.asarray(stacked[a, : e - s],
                                                np.float64))
        return float(tq.rie_grad_norm(qd, X))

    cfg = ts.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                        rtr_gradnorm_tol=tol / (2 * np.sqrt(N)))
    st32 = ts.initial_state(tp, X0.astype(np.float32), ranges, device="cpu")
    s32, _, _ = ts.make_run_fn(tp, cfg, device="cpu")(st32, 150, 0.0)
    g32 = central_gradnorm(s32.X.numpy())
    X_final, info = tdm.run_delta_certified(
        tp, stack(tp, ranges, X0, 3), cfg, tol=tol / 2, chunk=25,
        max_rounds=400, device="cpu")
    gd = central_gradnorm(X_final)
    assert g32 > tol, g32
    assert gd < tol and info["device_gradnorm"] < tol / 2, (gd, info)
    # the residual form holds at 30,000 units where the central matvec form
    # cancels at ~1e-3 relative
    assert tdm.host_certify(tp, X_final)[1] < tol
