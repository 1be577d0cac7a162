"""The fused edge term of the float32 CSR matvec (ops/edge_matvec.py): its
plain version against the JAX package, and the wrapper's checks on the CPU.
The CUDA kernel itself is tested on the card by tests/test_torch_gpu.py and
chip_smoke.py.

Tolerances: float32 sums taken in another order than JAX's (different
gathers, products and segment sums), so results agree to float32 rounding
scaled by the row's magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.ops import pallas_segsum as ps
from dpgo_tpu import quadratic as jq
import dpgo_tpu_torch
from dpgo_tpu_torch import datasets as td
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.ops import edge_matvec

from tests.test_torch_gpu import _random_case
from tests.test_torch_quadratic import _close, _data, _lifted_point

ATOL = 5e-5  # tests/test_pallas_segsum.py, scaled by the row magnitude
HIGHEST = jax.lax.Precision.HIGHEST


def _jax_edge_term(csr, V, out0):
    """out0 - segsum(V[src] E) - segsum(V[dst] E^T) by the JAX package: its
    einsum contributions and its Pallas segment sum in interpret mode, on
    the same sorted plans."""
    m, dh = csr.E_by_j.shape[0], csr.E_by_j.shape[-1]
    n, w = V.shape
    Vj = jnp.asarray(V)
    terms = []
    for idx, E, plan, spec in (
        (csr.src_by_j, csr.E_by_j, csr.plan_j, "mrb,mbc->mrc"),
        (csr.dst_by_i, csr.E_by_i, csr.plan_i, "mrb,mcb->mrc"),
    ):
        c = jnp.einsum(spec, Vj[idx.numpy()].reshape(m, w // dh, dh),
                       jnp.asarray(E.numpy()), precision=HIGHEST)
        jplan = ps.make_segsum_plan(plan.dest.numpy(), n, tile_rows=64,
                                    chunk=128)
        terms.append(np.asarray(ps.segment_sum_csr(c.reshape(m, w), jplan,
                                                   interpret=True)))
    return out0 - terms[0] - terms[1]


def _magnitude(csr, V, out0):
    """|out0| + the plain edge term on |V| and |E|: the row magnitude that
    scales the tolerance."""
    abs_csr = dataclasses.replace(csr, E_by_j=csr.E_by_j.abs(),
                                  E_by_i=csr.E_by_i.abs())
    mag = edge_matvec.edge_matvec_reference(
        torch.zeros(V.shape), torch.as_tensor(np.abs(V)), abs_csr)
    return np.abs(out0) + np.abs(mag.numpy())


@pytest.mark.parametrize(
    "n,m,r,dh,hot",
    [(200, 500, 5, 3, None),   # w = 15: the slice's width
     (150, 400, 5, 4, None),   # w = 20: d = 3
     (90, 300, 12, 3, None),   # w = 36: the column loop
     (100, 1000, 5, 3, 7)],    # one hot row, most rows empty
)
def test_reference_matches_jax_pallas_segsum(n, m, r, dh, hot):
    csr, V, out0 = _random_case(n, m, r, dh, seed=n + m, hot=hot)
    want = _jax_edge_term(csr, V, out0)
    got = edge_matvec.edge_matvec_reference(
        torch.as_tensor(out0.copy()), torch.as_tensor(V), csr).numpy()
    assert np.all(np.abs(got - want)
                  <= ATOL * np.maximum(_magnitude(csr, V, out0), 1.0))
    if hot is not None:
        assert csr.plan_j.row_ptr[hot + 1] - csr.plan_j.row_ptr[hot] == m


def test_reference_matches_jax_q_matvec_in_float32():
    """On city600 with the plans forced onto its 510 gather-path edges: the
    diagonal and band terms, then the plain edge term, against the JAX
    float32 q_matvec at HIGHEST precision."""
    r = 5
    jqd, tqd, n, d = _data("city600", r=r)
    t32 = tq.attach_csr_plans(tqd, min_edges=0).to(torch.float32)
    _, V = _lifted_point(n, r, d, seed=8)
    V32 = torch.as_tensor(V, dtype=torch.float32)
    # q_matvec without the gather-path edges: diagonal and band lanes only
    no_edges = dataclasses.replace(t32, off_i=t32.off_i[:0], off_j=t32.off_j[:0],
                                   off_E=t32.off_E[:0], csr=None)
    out = tq.q_matvec(no_edges, V32).reshape(n, r * (d + 1))
    got = edge_matvec.edge_matvec_reference(out, V32.reshape(n, -1), t32.csr)
    jqd32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x, jqd)
    want = jq.q_matvec(jqd32, jnp.asarray(V, jnp.float32), precision=HIGHEST)
    _close(got.reshape(n, r, d + 1), want, rtol=2e-5)
    # q_matvec's float32 CSR branch is exactly this
    np.testing.assert_array_equal(tq.q_matvec(t32, V32).numpy(),
                                  got.reshape(n, r, d + 1).numpy())


def test_cpu_wrapper_uses_the_plain_version_and_never_launches():
    csr, V, out0 = _random_case(120, 300, 5, 3, seed=4)
    before = edge_matvec.LAUNCHES
    got = edge_matvec.edge_matvec(torch.as_tensor(out0.copy()),
                                  torch.as_tensor(V), csr)
    ref = edge_matvec.edge_matvec_reference(torch.as_tensor(out0.copy()),
                                            torch.as_tensor(V), csr)
    assert edge_matvec.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    csr, V, out0 = _random_case(40, 90, 5, 3, seed=5)
    V, out = torch.as_tensor(V), torch.as_tensor(out0)
    with pytest.raises(TypeError):
        edge_matvec.edge_matvec(out.double(), V.double(), csr)
    with pytest.raises(ValueError):  # out of another shape
        edge_matvec.edge_matvec(out[:-1], V, csr)
    with pytest.raises(ValueError):  # rows that are not r * dh wide
        edge_matvec.edge_matvec(out[:, :14].contiguous(),
                                V[:, :14].contiguous(), csr)
    with pytest.raises(ValueError):  # not contiguous
        edge_matvec.edge_matvec(out, V.t().contiguous().t(), csr)
    with pytest.raises(ValueError):  # out overlapping V
        edge_matvec.edge_matvec(V, V, csr)
    with pytest.raises(ValueError):  # int32 gather indices
        edge_matvec.edge_matvec(out, V, dataclasses.replace(
            csr, src_by_j=csr.src_by_j.int()))
    with pytest.raises(ValueError):  # dh = 2 blocks
        c2, V2, o2 = _random_case(40, 90, 5, 2, seed=6)
        edge_matvec.edge_matvec(torch.as_tensor(o2), torch.as_tensor(V2), c2)


def test_solve_pgo_without_a_device_needs_the_card(monkeypatch):
    """No silent CPU run: with no CUDA device, solve_pgo raises unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges, _, _ = td.synthesize_grid3d(8, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dpgo_tpu_torch.solve_pgo(edges.to_measurements())
