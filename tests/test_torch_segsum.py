"""CSR segment sum: the port's plan and plain version against the JAX
package's Pallas kernel (interpret mode) and its scatter fallback, at the
shapes of tests/test_pallas_segsum.py. The CUDA kernel itself is tested on
the card by tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.ops import pallas_segsum as ps
from dpgo_tpu_torch.ops import segsum


def _both(dest, C, n, tr, ch):
    jplan = ps.make_segsum_plan(dest, n, tile_rows=tr, chunk=ch)
    kernel = np.asarray(ps.segment_sum_csr(jnp.asarray(C), jplan, interpret=True))
    xla = np.asarray(ps.segment_sum_xla(jnp.asarray(C), jplan))
    plan = segsum.make_segsum_plan(dest, n, device="cpu")
    ref = segsum.segment_sum_reference(torch.as_tensor(C), plan).numpy()
    got = segsum.segment_sum_csr(torch.as_tensor(C), plan).numpy()
    return kernel, xla, ref, got, plan


@pytest.mark.parametrize(
    "n,m,w,tr,ch",
    [
        (1000, 2600, 20, 128, 256),
        (517, 1399, 9, 64, 128),
        (100, 5, 12, 32, 64),
        (4096, 4096, 20, 256, 512),
        (37, 200, 4, 8, 128),
    ],
)
def test_segsum_matches_pallas_and_scatter(n, m, w, tr, ch):
    rng = np.random.default_rng(n + m)
    dest = np.sort(rng.integers(0, n, m)).astype(np.int32)
    C = rng.standard_normal((m, w)).astype(np.float32)
    kernel, xla, ref, got, plan = _both(dest, C, n, tr, ch)
    np.testing.assert_allclose(ref, xla, atol=5e-5)
    np.testing.assert_allclose(ref, kernel, atol=5e-5)
    np.testing.assert_array_equal(got, ref)  # CPU tensor: the plain version
    # row_ptr is the CSR offset array of dest
    counts = np.bincount(dest, minlength=n)
    np.testing.assert_array_equal(
        plan.row_ptr.numpy(), np.concatenate([[0], np.cumsum(counts)])
    )
    assert plan.row_ptr.dtype == torch.int32 and plan.m == m


def test_segsum_hotspot_and_empty_segments():
    rng = np.random.default_rng(7)
    n, m, w = 500, 1000, 8
    dest = np.full(m, 123, np.int32)  # all into one row; most rows empty
    C = rng.standard_normal((m, w)).astype(np.float32)
    kernel, xla, ref, got, _ = _both(dest, C, n, 64, 128)
    np.testing.assert_allclose(ref, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref, kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, ref)
    assert np.count_nonzero(np.any(ref != 0, axis=1)) == 1


def test_segsum_rejects_unsorted_and_out_of_range():
    with pytest.raises(AssertionError):
        ps.make_segsum_plan(np.array([3, 1, 2], np.int32), 10)
    with pytest.raises(ValueError, match="sorted"):
        segsum.make_segsum_plan(np.array([3, 1, 2], np.int32), 10, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        segsum.make_segsum_plan(np.array([1, 10], np.int32), 10, device="cpu")


def test_cpu_path_does_not_count_kernel_launches():
    plan = segsum.make_segsum_plan(np.array([0, 0, 2]), 3, device="cpu")
    before = segsum.LAUNCHES
    out = segsum.segment_sum_csr(torch.ones(3, 4), plan)
    assert segsum.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy()[:, 0], [2.0, 0.0, 1.0])
