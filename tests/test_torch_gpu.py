"""The CUDA kernels on the card (the segment sum and the fused edge
matvec), against their plain versions.

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor dpgo_tpu, so on a machine with a card but no JAX it
runs without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpgo_tpu_torch import datasets, quadratic
from dpgo_tpu_torch.ops import edge_matvec, lifted, segsum
from dpgo_tpu_torch.solvers import chordal, rtr

pytestmark = pytest.mark.gpu


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
    before = segsum.LAUNCHES
    out = segsum.segment_sum_csr(C, plan)
    again = segsum.segment_sum_csr(C, plan)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES == before + 2
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
    before = edge_matvec.LAUNCHES
    out = edge_matvec.edge_matvec(out0.clone(), V, csr)
    again = edge_matvec.edge_matvec(out0.clone(), V, csr)
    torch.cuda.synchronize()
    assert edge_matvec.LAUNCHES == before + 2
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
        before = edge_matvec.LAUNCHES
        _, stats = rtr.rtr_solve(qd, X0, 1e-2, 100.0, max_iterations=100,
                                 max_inner=200, inner_dtype=torch.float32)
        out[str(dev)] = (2 * float(stats.f_opt), float(stats.gnorm_opt),
                         edge_matvec.LAUNCHES - before, int(stats.tcg_iters))
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
        trace.append(kw["precond"]) or build(*a, **kw)))
    for dev in ("cpu", cuda):
        problem = quadratic.from_private_measurements(edges, n=n, d=3, device=dev)
        T = chordal.chordal_initialization_arrays(edges, n=n, device=dev)
        X0 = torch.einsum("rd,nde->nre",
                          lifted.fixed_stiefel_variable(3, 5, device=dev), T)
        trace = []
        before = edge_matvec.LAUNCHES
        _, stats = rtr.rtr_solve_auto(
            problem, X0, gradnorm_tol=1e-2, max_iterations=100,
            max_inner=200, probe_iterations=1, inner_dtype=torch.float32,
            device=dev)
        res[str(dev)] = (2 * float(stats.f_opt), float(stats.gnorm_opt),
                         edge_matvec.LAUNCHES - before, trace)
    f_cpu, _, l_cpu, p_cpu = res["cpu"]
    f_gpu, g_gpu, l_gpu, p_gpu = res["cuda"]
    assert p_cpu == p_gpu == ["jacobi", "banded"]
    assert l_cpu == 0 and l_gpu > 0 and g_gpu < 1e-2
    np.testing.assert_allclose(f_gpu, f_cpu, rtol=1e-6)
