"""The CUDA kernels on the card (the segment sum and the fused edge
matvec), against their plain versions; launches are read from trace.COUNTS.

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor dpgo_tpu, so on a machine with a card but no JAX it
runs without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpgo_tpu_torch import datasets, quadratic, trace
from dpgo_tpu_torch.ops import edge_matvec, lifted, segsum
from dpgo_tpu_torch.solvers import chordal, rtr

pytestmark = pytest.mark.gpu
EDGE, SEGSUM = "edge_matvec.launches", "segsum.launches"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(dest, n, w, seed, dev):
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.standard_normal((len(dest), w)).astype(np.float32),
                        device=dev)
    plan = segsum.make_segsum_plan(dest, n, device=dev)
    before = trace.COUNTS[SEGSUM]
    out = segsum.segment_sum_csr(C, plan)
    again = segsum.segment_sum_csr(C, plan)
    torch.cuda.synchronize()
    assert trace.COUNTS[SEGSUM] == before + 2
    assert torch.equal(out, again)  # no atomics: identical bits
    ref = segsum.segment_sum_reference(C, plan)
    mag = segsum.segment_sum_reference(C.abs(), plan)
    assert torch.all((out - ref).abs() <= 5e-5 * torch.clamp(mag, min=1.0))


@pytest.mark.parametrize(
    "n,m,w",
    [(1000, 2600, 20), (517, 1399, 9), (100, 5, 12), (4096, 4096, 20),
     (37, 200, 4), (50, 400, 70), (3000, 2800, 15)],
)
def test_kernel_matches_plain(cuda, n, m, w):
    rng = np.random.default_rng(n + m)
    _check(np.sort(rng.integers(0, n, m)), n, w, n + m, cuda)


def test_kernel_hotspot_and_empty_rows(cuda):
    _check(np.full(1000, 123), 500, 8, 7, cuda)
    _check(np.full(1000, 123), 500, 40, 8, cuda)  # the column loop, w > 32


def _random_case(n, m, r, dh, seed, hot=None, device="cpu"):
    """Random edges i -> j with float32 (dh, dh) blocks, sorted into CSR
    plans on `device`, and float32 (n, r*dh) numpy rows V and out0. With
    `hot`, every edge points into row `hot` from the first tenth of the rows:
    one row holds all ->j edges, and most rows are empty."""
    rng = np.random.default_rng(seed)
    if hot is None:
        i, j = rng.integers(0, n, m), rng.integers(0, n, m)
    else:
        i, j = rng.integers(0, max(1, n // 10), m), np.full(m, hot)
    E = rng.standard_normal((m, dh, dh)).astype(np.float32)
    csr = quadratic.make_csr_plans(
        torch.as_tensor(i, device=device), torch.as_tensor(j, device=device),
        torch.as_tensor(E, device=device), n)
    V = rng.standard_normal((n, r * dh)).astype(np.float32)
    out0 = rng.standard_normal((n, r * dh)).astype(np.float32)
    return csr, V, out0


@pytest.mark.parametrize(
    "n,m,r,dh,hot",
    [(1000, 2600, 5, 3, None), (517, 1399, 5, 4, None), (300, 900, 12, 3, None),
     (500, 1000, 5, 3, 123), (100, 5, 5, 3, None)],
)
def test_edge_matvec_matches_plain(cuda, n, m, r, dh, hot):
    """w = 15, 20 and 36, a row with 1,000 edges among empty rows, and
    nearly empty plans: the fused kernel against its plain version, and two
    runs with identical bits."""
    csr, V, out0 = _random_case(n, m, r, dh, seed=n + m, hot=hot, device=cuda)
    V = torch.as_tensor(V, device=cuda)
    out0 = torch.as_tensor(out0, device=cuda)
    before = trace.COUNTS[EDGE]
    out = edge_matvec.edge_matvec(out0.clone(), V, csr)
    again = edge_matvec.edge_matvec(out0.clone(), V, csr)
    torch.cuda.synchronize()
    assert trace.COUNTS[EDGE] == before + 2
    assert torch.equal(out, again)  # no atomics: identical bits
    ref = edge_matvec.edge_matvec_reference(out0.clone(), V, csr)
    abs_csr = dataclasses.replace(csr, E_by_j=csr.E_by_j.abs(),
                                  E_by_i=csr.E_by_i.abs())
    mag = out0.abs() + edge_matvec.edge_matvec_reference(
        torch.zeros_like(out0), V.abs(), abs_csr).abs()
    assert torch.all((out - ref).abs() <= 5e-5 * torch.clamp(mag, min=1.0))


def test_edge_matvec_rejects_what_it_does_not_take(cuda):
    csr, V, out0 = _random_case(40, 90, 5, 3, seed=1, device=cuda)
    V, out = torch.as_tensor(V, device=cuda), torch.as_tensor(out0, device=cuda)
    with pytest.raises(TypeError):
        edge_matvec.edge_matvec(out.double(), V.double(), csr)
    with pytest.raises(ValueError):  # plans on another device
        edge_matvec.edge_matvec(out, V, _random_case(40, 90, 5, 3, seed=1)[0])
    with pytest.raises(ValueError):
        edge_matvec.edge_matvec(V, V, csr)


def test_kernel_rejects_what_it_does_not_take(cuda):
    plan = segsum.make_segsum_plan(np.array([0, 1, 1]), 4, device=cuda)
    with pytest.raises(TypeError):
        segsum.segment_sum_csr(torch.ones(3, 5, dtype=torch.float64,
                                          device=cuda), plan)
    with pytest.raises(ValueError):
        segsum.segment_sum_csr(torch.ones(5, 3, device=cuda).t(), plan)
    with pytest.raises(ValueError):
        segsum.segment_sum_csr(torch.ones(4, 5, device=cuda), plan)
    cpu_plan = segsum.make_segsum_plan(np.array([0, 1, 1]), 4, device="cpu")
    with pytest.raises(ValueError):
        segsum.segment_sum_csr(torch.ones(3, 5, device=cuda), cpu_plan)


def test_mixed_slice_on_card_matches_cpu(cuda):
    """The slice at city2d(600) with the CSR plans forced on: the same cost
    on the card (through the fused edge kernel) as on the CPU."""
    edges, n, _ = datasets.synthesize_city2d(600, seed=0)
    d, r = 2, 5
    out = {}
    for dev in ("cpu", cuda):
        problem = quadratic.from_private_measurements(edges, n=n, d=d, device=dev)
        T = chordal.chordal_initialization_arrays(edges, n=n, device=dev)
        X0 = torch.einsum(
            "rd,nde->nre", lifted.fixed_stiefel_variable(d, r, device=dev), T)
        qd = quadratic.build_quadratic_data(
            problem, torch.zeros((1, r, d + 1), dtype=torch.float64,
                                 device=dev), r=r)
        qd = quadratic.attach_csr_plans(qd, min_edges=0)
        before = trace.COUNTS[EDGE]
        _, stats = rtr.rtr_solve(qd, X0, 1e-2, 100.0, max_iterations=100,
                                 max_inner=200, inner_dtype=torch.float32)
        out[str(dev)] = (2 * float(stats.f_opt), float(stats.gnorm_opt),
                         trace.COUNTS[EDGE] - before, int(stats.tcg_iters))
    f_cpu, _, launches_cpu, _ = out["cpu"]
    f_gpu, g_gpu, launches_gpu, tcg = out["cuda"]
    assert launches_cpu == 0 and launches_gpu >= tcg > 0
    assert g_gpu < 1e-2
    np.testing.assert_allclose(f_gpu, f_cpu, rtol=1e-6)


def _grid_team(dev, A=4, r=5, n=125):
    from dpgo_tpu_torch.parallel import spmd
    from dpgo_tpu_torch.solvers.pgo import chordal_initialization

    edges, n, _ = datasets.synthesize_grid3d(n, seed=0)
    meas = edges.to_measurements()
    problem, ranges = spmd.build_spmd_problem(meas, n, A, r, device=dev)
    T = chordal_initialization(meas, device=dev)
    X0 = torch.einsum("rd,nde->nre",
                      lifted.fixed_stiefel_variable(3, r, device=dev), T)
    return problem, spmd.initial_state(problem, X0, ranges, device=dev)


@pytest.mark.parametrize("mode", ["all", "greedy"])
def test_spmd_rounds_on_card_match_cpu(cuda, mode):
    """Three accelerated rounds with the per-agent banded factor and the SVD
    projection (float64): the card's state and metrics against the CPU's."""
    from dpgo_tpu_torch.parallel import spmd

    cfg = spmd.SPMDConfig(mode=mode, adaptive_restart=True, nesterov_n=5,
                          rtr_gradnorm_tol=1e-3)
    out = {}
    for dev in ("cpu", cuda):
        problem, state = _grid_team(dev)
        step = spmd.make_step_fn(problem, cfg, device=dev)
        assert step.precond == "banded"
        sel = -1 if mode == "all" else 0
        sels = []
        for _ in range(3):
            state, metrics, sel = step(state, sel)
            sels.append(sel)
        out[str(dev)] = (state.X.cpu(), metrics, sels)
    (Xc, mc, sc), (Xg, mg, sg) = out["cpu"], out["cuda"]
    assert sc == sg
    torch.testing.assert_close(Xg, Xc, rtol=0, atol=1e-9)
    for k in ("cost", "gradnorm"):
        np.testing.assert_allclose(float(getattr(mg, k)), float(getattr(mc, k)),
                                   rtol=1e-9)


def test_banded_solve_on_card_matches_cpu(cuda):
    """The exact banded factor, built and applied on the card, against the
    CPU's (float64)."""
    from dpgo_tpu_torch.ops import block_tridiag

    edges, n, _ = datasets.synthesize_grid3d(1000, seed=0)
    V = np.random.default_rng(0).standard_normal((n, 5, 4))
    out = []
    for dev in ("cpu", cuda):
        problem = quadratic.from_private_measurements(edges, n=n, d=3, device=dev)
        qd = quadratic.build_q_data(problem, 5, precond="banded")
        assert isinstance(qd.btf, block_tridiag.BandedFactor)
        out.append(quadratic.precond_solve(
            qd, torch.as_tensor(V, device=dev)).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=1e-10, atol=1e-12)


def test_rtr_solve_auto_escalates_on_card(cuda, monkeypatch):
    """A one-iteration Jacobi probe, then the banded factor in float32 with
    the CSR plans attached: the card launches the fused edge kernel and
    lands on the CPU's cost."""
    edges, n, _ = datasets.synthesize_grid3d(3375, seed=0)
    res = {}
    build = quadratic.build_quadratic_data
    monkeypatch.setattr(quadratic, "build_quadratic_data", lambda *a, **kw: (
        preconds.append(kw["precond"]) or build(*a, **kw)))
    for dev in ("cpu", cuda):
        problem = quadratic.from_private_measurements(edges, n=n, d=3, device=dev)
        T = chordal.chordal_initialization_arrays(edges, n=n, device=dev)
        X0 = torch.einsum("rd,nde->nre",
                          lifted.fixed_stiefel_variable(3, 5, device=dev), T)
        preconds = []
        before = trace.COUNTS[EDGE]
        _, stats = rtr.rtr_solve_auto(
            problem, X0, gradnorm_tol=1e-2, max_iterations=100,
            max_inner=200, probe_iterations=1, inner_dtype=torch.float32,
            device=dev)
        res[str(dev)] = (2 * float(stats.f_opt), float(stats.gnorm_opt),
                         trace.COUNTS[EDGE] - before, preconds)
    f_cpu, _, l_cpu, p_cpu = res["cpu"]
    f_gpu, g_gpu, l_gpu, p_gpu = res["cuda"]
    assert p_cpu == p_gpu == ["jacobi", "banded"]
    assert l_cpu == 0 and l_gpu > 0 and g_gpu < 1e-2
    np.testing.assert_allclose(f_gpu, f_cpu, rtol=1e-6)


def test_residual_control_on_card_matches_cpu(cuda):
    """rtr_solve under the residual-form control (float32 tCG and control)
    at city2d(600) with the CSR plans forced on: the card launches the fused
    edge kernel once per tCG iteration and lands on the CPU's float64 cost;
    the residual form itself agrees with the CPU's to float64 rounding (its
    scatter-adds are atomics on the card)."""
    edges, n, _ = datasets.synthesize_city2d(600, seed=0)
    d, r = 2, 5
    out = {}
    for dev in ("cpu", cuda):
        problem = quadratic.from_private_measurements(edges, n=n, d=d, device=dev)
        T = chordal.chordal_initialization_arrays(edges, n=n, device=dev)
        X0 = torch.einsum(
            "rd,nde->nre", lifted.fixed_stiefel_variable(d, r, device=dev), T)
        nbr = torch.zeros((1, r, d + 1), dtype=torch.float64, device=dev)
        qd = quadratic.build_quadratic_data(problem, nbr, r=r)
        qd = dataclasses.replace(
            qd, res=quadratic.build_residual_data(problem, nbr))
        qd = quadratic.attach_csr_plans(qd, min_edges=0)
        f0, g0 = quadratic.cost_grad_residual(qd.res, X0)
        before = trace.COUNTS[EDGE]
        X, stats = rtr.rtr_solve(qd, X0, 1e-2, 100.0, max_iterations=100,
                                 max_inner=200, inner_dtype=torch.float32,
                                 residual_control=True)
        out[str(dev)] = (2 * float(quadratic.cost(qd, X)),
                         float(quadratic.rie_grad_norm(qd, X)),
                         trace.COUNTS[EDGE] - before, int(stats.tcg_iters),
                         float(f0), g0.cpu())
    f_cpu, _, l_cpu, _, f0_cpu, g0_cpu = out["cpu"]
    f_gpu, g_gpu, l_gpu, tcg, f0_gpu, g0_gpu = out["cuda"]
    assert l_cpu == 0 and l_gpu >= tcg > 0 and g_gpu < 1e-2
    np.testing.assert_allclose(f_gpu, f_cpu, rtol=1e-6)
    np.testing.assert_allclose(f0_gpu, f0_cpu, rtol=1e-12)
    torch.testing.assert_close(g0_gpu, g0_cpu, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["uniform", "async"])
def test_randomized_modes_on_card_match_cpu(cuda, mode, tmp_path):
    """Four rounds with injected draws on the card against the CPU's, the
    card's own draw equal to the CPU's (the generator lives on the CPU), and
    a checkpoint written on the card loading on either device."""
    from dpgo_tpu_torch.parallel import spmd

    draws = {"uniform": [2, 0, 3, 1],
             "async": [[True, False, True, True], [False, True, False, False],
                       [True, True, False, True], [False, False, True, True]]}
    out = {}
    for dev in ("cpu", cuda):
        problem, state = _grid_team(dev)
        cfg = spmd.SPMDConfig(mode=mode, acceleration=False,
                              rtr_gradnorm_tol=1e-3)
        s, m, _ = spmd.make_run_fn(problem, cfg, device=dev,
                                   selections=draws[mode])(state, 4, 0.0)
        own, _, _ = spmd.make_run_fn(problem, cfg, device=dev)(state, 4, 0.0)
        out[str(dev)] = (s, m, own)
    (sc, mc, oc), (sg, mg, og) = out["cpu"], out["cuda"]
    torch.testing.assert_close(sg.X.cpu(), sc.X, rtol=0, atol=1e-9)
    torch.testing.assert_close(og.X.cpu(), oc.X, rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(mg.cost), float(mc.cost), rtol=1e-9)
    path = str(tmp_path / "card.npz")
    spmd.save_state(sg, path)
    for dev in ("cpu", cuda):
        back = spmd.load_state(path, device=dev)
        assert back.X.device.type == torch.device(dev).type
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(back, sg))
    assert spmd.load_state(path).X.is_cuda  # the default is the card


def test_gnc_on_card_matches_cpu(cuda):
    """run_rbcd_gnc on city2d(200) with 10% planted outliers in 2 agents:
    the card rejects exactly the planted edges, as the CPU does, with the
    same weights to 1e-8."""
    from dpgo_tpu_torch.parallel import spmd
    from dpgo_tpu_torch.solvers.pgo import chordal_initialization

    edges, n, _ = datasets.synthesize_city2d(200, seed=3)
    meas, planted = datasets.plant_outliers(edges.to_measurements(), n,
                                            frac=0.10, seed=5)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    out = {}
    for dev in ("cpu", cuda):
        problem, ranges = spmd.build_spmd_problem(meas, n, 2, 3, device=dev)
        T = chordal_initialization(meas, device=dev)
        X0 = torch.einsum("rd,nde->nre",
                          lifted.fixed_stiefel_variable(2, 3, device=dev), T)
        state = spmd.initial_state(problem, X0, ranges, device=dev)
        p_out, _, hist = spmd.run_rbcd_gnc(
            problem, state, cfg, barc=5.0, num_weight_updates=8,
            inner_rounds=15, device=dev)
        assert p_out.priv_weight.device.type == torch.device(dev).type
        out[str(dev)] = (spmd.edge_weight_table(p_out, ranges), hist)
    (tc, hc), (tg, hg) = out["cpu"], out["cuda"]
    assert [h["rounds"] for h in hc] == [h["rounds"] for h in hg]
    assert [e["pair"] for e in tc] == [e["pair"] for e in tg]
    np.testing.assert_allclose([e["weight"] for e in tg],
                               [e["weight"] for e in tc], rtol=0, atol=1e-8)
    rejected = {e["pair"] for e in tg if not e["fixed"] and e["weight"] < 1e-6}
    assert rejected == planted


def test_robust_pgo_and_odometry_on_card_match_cpu(cuda):
    """solve_robust_pgo on grid3d(64) with planted outliers, and the
    odometry chain of city2d(5000): the card against the CPU."""
    from dpgo_tpu_torch.solvers import pgo
    from dpgo_tpu_torch.types import ROptParameters

    edges, n, _ = datasets.synthesize_grid3d(64, seed=0)
    meas, planted = datasets.plant_outliers(edges.to_measurements(), n,
                                            frac=0.15, seed=1)
    params = pgo.SolveRobustPGOParams(opt_params=ROptParameters(
        gradnorm_tol=1e-6, RTR_iterations=30, RTR_tCG_iterations=100))
    Tc, oc = pgo.solve_robust_pgo(meas, params, device="cpu")
    Tg, og = pgo.solve_robust_pgo(meas, params)  # the default is the card
    assert Tg.is_cuda
    np.testing.assert_allclose([m.weight for m in og],
                               [m.weight for m in oc], rtol=0, atol=1e-8)
    assert planted <= {(m.p1, m.p2) for m in og if m.weight < 1e-8}
    torch.testing.assert_close(Tg.cpu(), Tc, rtol=0, atol=1e-6)
    chain, nc, _ = datasets.synthesize_city2d(5000, seed=0)
    keep = np.nonzero(chain.p2 - chain.p1 == 1)[0]
    odo = dataclasses.replace(chain, **{
        f.name: getattr(chain, f.name)[keep]
        for f in dataclasses.fields(chain)})
    a = chordal.odometry_initialization_arrays(odo, n=nc, device="cpu")
    b = chordal.odometry_initialization_arrays(odo, n=nc, device=cuda)
    torch.testing.assert_close(b.cpu(), a, rtol=0,
                               atol=1e-10 * float(a.abs().max()))


@pytest.mark.parametrize("kind", ["grid3d", "city2d"])
def test_delta_rounds_on_card_match_cpu(cuda, kind):
    """Six delta rounds (float32 problem, 'exact' restart, a re-anchor
    after round 3) from the same float64 anchor on the card and on the
    CPU: the metrics within 1e-4 relative (the scatter-adds are atomics on
    the card) and no kernel launch (no CSR plans on this path)."""
    from dpgo_tpu_torch.parallel import delta, spmd

    synth = datasets.synthesize_grid3d if kind == "grid3d" \
        else datasets.synthesize_city2d
    edges, n, _ = synth(216 if kind == "grid3d" else 600, seed=0)
    meas = edges.to_measurements()
    d = edges.d
    T = chordal.chordal_initialization_arrays(edges, n=n, device="cpu")
    X0 = torch.einsum("rd,nde->nre",
                      lifted.fixed_stiefel_variable(d, 5, device="cpu"), T)
    cfg = spmd.SPMDConfig(acceleration=True, adaptive_restart=True,
                          restart_interval=10**6, nesterov_n=5,
                          rtr_tcg_iterations=20, restart_scheme="exact",
                          rtr_gradnorm_tol=1e-3)
    out = {}
    before = (trace.COUNTS[EDGE], trace.COUNTS[SEGSUM])
    for dev in ("cpu", cuda):
        p64, ranges = spmd.build_spmd_problem(meas, n, 4, 5, device=dev)
        p32, _ = spmd.build_spmd_problem(meas, n, 4, 5, dtype=torch.float32,
                                         device=dev)
        Xs = spmd.initial_state(p64, X0, ranges, device=dev).X.cpu().numpy()
        run = delta.make_delta_run_fn(p32, cfg, reanchor_every=3, device=dev)
        ref = delta.build_delta_ref(p32, Xs, device=dev)
        state, ref, m, rounds = run(ref, delta.initial_delta_state(ref), 6,
                                    0.0)
        out[str(dev)] = (m, rounds, (state.ACC + state.D).cpu())
    torch.cuda.synchronize()
    assert (trace.COUNTS[EDGE], trace.COUNTS[SEGSUM]) == before
    (mc, rc, Pc), (mg, rg, Pg) = out["cpu"], out["cuda"]
    assert rc == rg == 6
    for k in ("cost", "gradnorm"):
        np.testing.assert_allclose(float(getattr(mg, k)),
                                   float(getattr(mc, k)), rtol=1e-4)
    torch.testing.assert_close(Pg, Pc, rtol=0,
                               atol=1e-4 * float(Pc.abs().max()))


def test_certificate_on_card_matches_cpu(cuda):
    """certificate_matvec and kkt_multipliers (float64) on the card against
    the CPU to 1e-12 relative, and min_eig_certificate's verdict and
    lambda_min from the same start within 1e-9."""
    from dpgo_tpu_torch.solvers import certify

    edges, n, _ = datasets.synthesize_grid3d(125, seed=0)
    V = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3, 4)))
    out = {}
    for dev in ("cpu", cuda):
        problem = quadratic.from_private_measurements(edges, n=n, d=3,
                                                      device=dev)
        qd = quadratic.build_quadratic_data(
            problem, torch.zeros((1, 5, 4), dtype=torch.float64, device=dev),
            r=5, precond="auto")
        T = chordal.chordal_initialization_arrays(edges, n=n, device=dev)
        X0 = torch.einsum("rd,nde->nre",
                          lifted.fixed_stiefel_variable(3, 5, device=dev), T)
        X, _ = rtr.rtr_solve(qd, X0, 1e-8, 100.0, max_iterations=100,
                             max_inner=200)
        Lam = certify.kkt_multipliers(qd, X)
        SV = certify.certificate_matvec(qd, Lam, V.to(dev))
        cert = certify.min_eig_certificate(qd, X, k=64)
        out[str(dev)] = (Lam.cpu(), SV.cpu(), cert)
    (Lc, Sc, cc), (Lg, Sg, cg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(Lg, Lc, rtol=0,
                               atol=1e-12 * float(Lc.abs().max()))
    torch.testing.assert_close(Sg, Sc, rtol=0,
                               atol=1e-12 * float(Sc.abs().max()))
    assert cg.certified == cc.certified is True
    assert abs(cg.lambda_min - cc.lambda_min) <= 1e-9


def test_agent_local_solve_on_card_matches_cpu(cuda):
    """One robot of grid3d(125) in 3, with Nesterov acceleration: the same
    X, neighbor and aux poses on both devices, three iterate() calls (local
    solve, Y/V projections), X, Y and V within 1e-10; the pose messages are
    host arrays."""
    from dpgo_tpu_torch import agent as agent_mod
    from dpgo_tpu_torch.parallel import partition
    from dpgo_tpu_torch.types import (PGOAgentParameters, PGOAgentState,
                                      PGOAgentStatus, ROptParameters)

    edges, n, _ = datasets.synthesize_grid3d(125, seed=1)
    odo, priv, shared, _ = partition.partition_measurements(
        edges.to_measurements(), n, 3)
    params = PGOAgentParameters(d=3, r=5, num_robots=3, acceleration=True,
                                local_opt_params=ROptParameters(RTR_iterations=1))
    rng = np.random.default_rng(0)
    agents = {}
    for dev in ("cpu", cuda):
        a = agent_mod.PGOAgent(1, params, device=dev)
        a.set_lifting_matrix(lifted.fixed_stiefel_variable(3, 5, device="cpu"))
        a.set_measurements(odo[1], priv[1], shared[1])
        a.initialize()
        agents[str(dev)] = a
    # robot 1 waits for its neighbors to initialize: set_X initializes it
    X0 = lifted.project_lifted(torch.as_tensor(rng.standard_normal(
        (agents["cpu"].num_poses(), 5, 4)))).numpy()
    nbr = {pid: lifted.project_lifted(torch.as_tensor(
        rng.standard_normal((1, 5, 4)))).numpy()[0]
        for pid in sorted(agents["cpu"].pose_graph.nbr_shared_pose_ids)}
    for a in agents.values():
        a.set_X(X0)
        for rid in (0, 2):
            a.set_neighbor_status(PGOAgentStatus(rid, PGOAgentState.INITIALIZED))
            mine = {p: v for p, v in nbr.items() if p.robot_id == rid}
            a.update_neighbor_poses(rid, mine)
            a.update_aux_neighbor_poses(rid, mine)
        for _ in range(3):
            assert a.iterate(True)
    c, g = agents["cpu"], agents["cuda"]
    assert g.X.is_cuda and isinstance(g.get_shared_pose_dict(), dict)
    assert all(isinstance(v, np.ndarray)
               for v in g.get_shared_pose_dict().values())
    for k in ("X", "Y", "V"):
        torch.testing.assert_close(getattr(g, k).cpu(), getattr(c, k),
                                   rtol=0, atol=1e-10)
    assert g.local_opt_result.fOpt == pytest.approx(c.local_opt_result.fOpt,
                                                    rel=1e-10)


def _mesh_steps(mesh, team, mode):
    """A rank: three rounds of the team on the mesh's card."""
    from dpgo_tpu_torch.parallel import mesh as mesh_mod
    from dpgo_tpu_torch.parallel import spmd

    problem, state = mesh_mod.to_device(team, mesh.device)
    cfg = spmd.SPMDConfig(mode=mode, adaptive_restart=True, nesterov_n=5,
                          rtr_gradnorm_tol=1e-3)
    step = spmd.make_step_fn(problem, cfg, mesh=mesh)
    sel, sels = (-1 if mode == "all" else 0), []
    for _ in range(3):
        state, metrics, sel = step(state, sel)
        sels.append(sel)
    return (state.X.cpu().numpy(), [float(x) for x in metrics], sels,
            str(mesh.device), mesh.backend)


@pytest.mark.parametrize("mode", ["all", "greedy"])
def test_mesh_of_two_gloo_ranks_on_one_card_matches_one_device(cuda, mode):
    """Two gloo ranks sharing cuda:0 (2 agents each): every rank returns
    the same team-wide state, within 1e-9 of the team on one device (float64,
    the card's atomics), with the same greedy sequence."""
    from dpgo_tpu_torch.parallel import mesh as mesh_mod
    from dpgo_tpu_torch.parallel import spmd

    team = _grid_team("cpu")
    out = mesh_mod.spawn(_mesh_steps, 2, backend="gloo", device="cuda:0",
                         args=(mesh_mod.to_host(team), mode), timeout=300)
    assert [o[3:] for o in out] == [("cuda:0", "gloo")] * 2
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1:3] == out[1][1:3]
    problem, state = (mesh_mod.to_device(mesh_mod.to_host(team), cuda))
    cfg = spmd.SPMDConfig(mode=mode, adaptive_restart=True, nesterov_n=5,
                          rtr_gradnorm_tol=1e-3)
    step = spmd.make_step_fn(problem, cfg, device=cuda)
    sel, sels = (-1 if mode == "all" else 0), []
    for _ in range(3):
        state, metrics, sel = step(state, sel)
        sels.append(sel)
    X, m, s, _, _ = out[0]
    assert s == sels
    np.testing.assert_allclose(X, state.X.cpu().numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(m[:2], [float(metrics.cost),
                                       float(metrics.gradnorm)], rtol=1e-9)


def test_native_g2o_parser_and_single_robot_example_on_the_card(cuda,
                                                                 tmp_path):
    """The port's native g2o parser loads from build/dpgo_tpu_torch/, and
    the single robot example runs on the card by default (grid3d(125)),
    reading its file with that parser and ending below gradnorm 1e-2."""
    import json
    import os
    import subprocess
    import sys

    from dpgo_tpu_torch.io import g2o
    from dpgo_tpu_torch.ops import _build

    edges, n, _ = datasets.synthesize_grid3d(125, seed=1)
    path = str(tmp_path / "grid125.g2o")
    datasets.write_g2o(edges, path)
    got, m = g2o.read_g2o_arrays(path)
    assert g2o.LAST_PARSER == "native" and m == n and got.m == edges.m
    assert g2o.native_library_path().parent == _build.BUILD_DIR
    assert g2o.native_library_path().is_file()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable,
         os.path.join(repo, "examples", "torch_single_robot_example.py"),
         path], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    stats = json.loads(p.stdout.strip().splitlines()[-1][len("stats: "):])
    assert stats["device"].startswith("cuda") and stats["parser"] == "native"
    last = [ln for ln in p.stdout.splitlines() if ln.startswith("Iter")][-1]
    assert float(last.split("gradnorm = ")[1].split()[0]) < 1e-2


def _pcg_both_ways(monkeypatch, stages):
    """Each chordal PCG stage run twice on the same inputs: through the
    CUDA graph, with every block under sync debug mode "error" (a host read
    inside a block raises), then as the eager masked loop. Appends (graph
    iterate, eager iterate, graph counts, eager counts) per stage."""
    real_pcg, real_graphed = chordal._pcg, chordal._graphed

    def strict(step, device):
        run_steps = real_graphed(step, device)

        def run(n):
            torch.cuda.set_sync_debug_mode("error")
            try:
                run_steps(n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    def both(*args, **kwargs):
        out = []
        for graphed in (strict, lambda step, device: chordal._eager(step)):
            with monkeypatch.context() as m:
                m.setattr(chordal, "_graphed", graphed)
                before = trace.COUNTS.copy()
                x = real_pcg(*args, **kwargs)
                out.append((x, trace.COUNTS - before))
        stages.append((out[0][0], out[1][0], out[0][1], out[1][1]))
        return out[0][0]

    monkeypatch.setattr(chordal, "_pcg", both)


def _check_stages(stages, launches_per_step):
    K = chordal.BLOCK
    assert len(stages) == 2
    for x, x_eager, graph, eager in stages:
        steps = graph["chordal.pcg_steps"]
        assert torch.equal(x, x_eager) and x.is_cuda
        assert graph["chordal.pcg_iters"] == eager["chordal.pcg_iters"] > 0
        assert steps == eager["chordal.pcg_steps"] and steps % K == 0
        assert graph["chordal.graph_replays"] == steps - 1
        assert eager["chordal.graph_replays"] == 0
        assert trace.syncs(graph) == graph["sync.chordal.pcg"] == steps // K
        # each step's launches and the stage's initial residual
        for counts in (graph, eager):
            assert counts["chordal_laplacian.launches"] \
                == launches_per_step * (steps + 1)


def test_chordal_pcg_graph_matches_eager_through_the_kernel(cuda,
                                                           monkeypatch):
    """A float32 city init on the card: the kernel launches once a step,
    plus 3; graph replays run; and each stage's graph gives the eager
    masked loop's bits and iteration count with no host read in a block."""
    edges, n, _ = datasets.synthesize_city2d(2000, seed=0)
    kw = dict(n=n, cg_dtype=torch.float32, tol=1e-6, maxiter=1000,
              device=cuda)
    before = trace.COUNTS.copy()
    T = chordal.chordal_initialization_arrays(edges, **kw)
    delta = trace.COUNTS - before
    steps = delta["chordal.pcg_steps"]
    assert delta["chordal_laplacian.launches"] == steps + 3
    assert delta["chordal.graph_replays"] == steps - 2 > 0
    assert steps % chordal.BLOCK == 0
    assert delta["chordal.pcg_iters"] <= steps
    assert torch.isfinite(T).all()
    stages = []
    _pcg_both_ways(monkeypatch, stages)
    chordal.chordal_initialization_arrays(edges, **kw)
    _check_stages(stages, 1)


def test_chordal_pcg_graph_matches_eager_in_float64(cuda, monkeypatch):
    """pgo.chordal_initialization on the card (float64, the plain operator
    with its index_add_s, deterministic kernels so that two runs can agree):
    each stage captures and gives the eager masked loop's bits."""
    from dpgo_tpu_torch.solvers.pgo import chordal_initialization

    edges, n, _ = datasets.synthesize_grid3d(1000, seed=0)
    stages = []
    _pcg_both_ways(monkeypatch, stages)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        T = chordal_initialization(edges.to_measurements(), device=cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    _check_stages(stages, 0)
    assert T.dtype == torch.float64 and torch.isfinite(T).all()


def test_certificate_refinement_graph_matches_eager(cuda, monkeypatch):
    """certify._refine_min on the card where the refinement runs (the
    chordal init of a 1,000-pose grid, precond 'auto', float64,
    deterministic kernels): every block replays the captured iteration
    with no host read inside (sync debug mode "error"), and gives the
    eager masked loop's bits, iteration count and reads."""
    from dpgo_tpu_torch.solvers import certify

    edges, n, _ = datasets.synthesize_grid3d(1000, seed=0)
    real = chordal._graphed

    def strict(step, device, replays):
        run_steps = real(step, device, replays)

        def run(k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                run_steps(k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    T = chordal.chordal_initialization_arrays(edges, n=n, device=cuda)
    X = torch.einsum("rd,nde->nre",
                     lifted.fixed_stiefel_variable(3, 5, device=cuda), T)
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed in (strict, lambda step, device, replays:
                        chordal._eager(step)):
            with monkeypatch.context() as m:
                m.setattr(chordal, "_graphed", graphed)
                before = trace.COUNTS.copy()
                c = certify.certify_solution(edges, X, refine_iters=100,
                                             device=cuda)
                out.append((c, trace.COUNTS - before))
    finally:
        torch.use_deterministic_algorithms(False)
    (cg, graph), (ce, eager) = out
    assert 0 < cg.refine_iters == ce.refine_iters
    blocks = -(-(cg.refine_iters + (cg.refine_iters < 100))
               // certify.REFINE_BLOCK)
    assert graph["certify.graph_replays"] == blocks * certify.REFINE_BLOCK - 1
    assert eager["certify.graph_replays"] == 0
    assert graph["sync.certify.refine"] == eager["sync.certify.refine"] \
        == blocks + 1
    for f in ("lambda_min", "lambda_min_lower", "eig_residual", "ritz",
              "stationarity"):
        assert getattr(cg, f) == getattr(ce, f), f
    assert np.array_equal(cg.eigvec, ce.eigvec)
