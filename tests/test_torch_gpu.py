"""The CUDA segment-sum kernel on the card, against its plain version.

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor dpgo_tpu, so on a machine with a card but no JAX it
runs without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from dpgo_tpu_torch import datasets, quadratic
from dpgo_tpu_torch.ops import segsum
from dpgo_tpu_torch.solvers import chordal, rtr
from dpgo_tpu_torch.ops import lifted

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
     (37, 200, 4), (50, 400, 70)],
)
def test_kernel_matches_plain(cuda, n, m, w):
    rng = np.random.default_rng(n + m)
    _check(np.sort(rng.integers(0, n, m)), n, w, n + m, cuda)


def test_kernel_hotspot_and_empty_rows(cuda):
    _check(np.full(1000, 123), 500, 8, 7, cuda)


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
    on the card (through the kernel) as on the CPU."""
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
        before = segsum.LAUNCHES
        _, stats = rtr.rtr_solve(qd, X0, 1e-2, 100.0, max_iterations=100,
                                 max_inner=200, inner_dtype=torch.float32)
        out[str(dev)] = (2 * float(stats.f_opt), float(stats.gnorm_opt),
                         segsum.LAUNCHES - before, int(stats.tcg_iters))
    f_cpu, _, launches_cpu, _ = out["cpu"]
    f_gpu, g_gpu, launches_gpu, tcg = out["cuda"]
    assert launches_cpu == 0 and launches_gpu >= 2 * tcg > 0
    assert g_gpu < 1e-2
    np.testing.assert_allclose(f_gpu, f_cpu, rtol=1e-6)
