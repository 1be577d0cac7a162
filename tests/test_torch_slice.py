"""The centralized lifted solve, end to end, in both packages.

edges -> from_private_measurements -> chordal init -> lift by the fixed
Stiefel matrix -> build_quadratic_data(precond="jacobi") -> [attach CSR
plans] -> rtr_solve -> cost and gradnorm, the sequence of
bench.run_city10000_central, at small sizes on the CPU. Costs are compared
in one convention: f = 0.5 <XQ, X> + <X, G> as rtr_solve returns it.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu import quadratic as jq
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.solvers import chordal as jc
from dpgo_tpu.solvers import rtr as jr
from dpgo_tpu_torch import datasets as td
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.ops import lifted as tl
from dpgo_tpu_torch.ops import segsum
from dpgo_tpu_torch.solvers import chordal as tc
from dpgo_tpu_torch.solvers import rtr as tr

SOLVE = dict(gradnorm_tol=1e-2, initial_radius=100.0, max_iterations=100,
             max_inner=200)


def _graphs(name):
    if name == "city600":
        return (jd.synthesize_city2d(600, seed=0)[:2],
                td.synthesize_city2d(600, seed=0)[:2], 2)
    return (jd.synthesize_grid3d(125, seed=0)[:2],
            td.synthesize_grid3d(125, seed=0)[:2], 3)


def _jax_slice(edges, n, d, r, mixed, **solve):
    problem = jq.from_private_measurements(edges, n=n, d=d)
    T = jc.chordal_initialization_arrays(
        edges, n=n, cg_dtype=jnp.float32 if mixed else None,
        tol=1e-6 if mixed else 1e-10, maxiter=1000)
    X0 = jnp.einsum("rd,nde->nre", jl.fixed_stiefel_variable(d, r), T)
    qd = jq.build_quadratic_data(problem, jnp.zeros((1, r, d + 1)), r=r,
                                 precond="jacobi")
    return jr.rtr_solve(qd, X0, inner_dtype=jnp.float32 if mixed else None,
                        **solve)


def _torch_slice(edges, n, d, r, mixed, min_edges=4096, **solve):
    dev = "cpu"
    problem = tq.from_private_measurements(edges, n=n, d=d, device=dev)
    T = tc.chordal_initialization_arrays(
        edges, n=n, cg_dtype=torch.float32 if mixed else None,
        tol=1e-6 if mixed else 1e-10, maxiter=1000, device=dev)
    X0 = torch.einsum("rd,nde->nre", tl.fixed_stiefel_variable(d, r, device=dev), T)
    qd = tq.build_quadratic_data(
        problem, torch.zeros((1, r, d + 1), dtype=torch.float64), r=r,
        precond="jacobi")
    qd = tq.attach_csr_plans(qd, min_edges=min_edges)
    X, stats = tr.rtr_solve(qd, X0, inner_dtype=torch.float32 if mixed else None,
                            **solve)
    return X, stats, qd


@pytest.mark.parametrize("name,r", [("city600", 5), ("grid125", 5)])
def test_slice_float64_follows_the_jax_trajectory(name, r):
    (je, n, ), (te, _), d = _graphs(name)
    _, js = _jax_slice(je, n, d, r, mixed=False, **SOLVE)
    X, ts, _ = _torch_slice(te, n, d, r, mixed=False, **SOLVE)
    assert ts.iterations == int(js.iterations)
    assert int(ts.tcg_iters) == int(js.tcg_iters)
    np.testing.assert_allclose(float(ts.f_opt), float(js.f_opt), rtol=1e-8)
    np.testing.assert_allclose(float(ts.f_init), float(js.f_init), rtol=1e-8)
    assert float(ts.gnorm_opt) < 1e-2 and X.dtype == torch.float64


def test_slice_mixed_precision_through_the_csr_path(monkeypatch):
    """float32 tCG, float64 control, CSR plans forced onto the 510 gather-path
    edges: the inner matvecs go through the segment sum (its plain version
    on the CPU) and both packages reach the tolerance at the same cost."""
    (je, n), (te, _), d = _graphs("city600")
    calls = []
    ref_fn = segsum.segment_sum_reference
    monkeypatch.setattr(segsum, "segment_sum_reference",
                        lambda c, p: calls.append(c.dtype) or ref_fn(c, p))
    _, js = _jax_slice(je, n, d, 5, mixed=True, **SOLVE)
    _, ts, qd = _torch_slice(te, n, d, 5, mixed=True, min_edges=0, **SOLVE)
    assert qd.csr is not None and qd.off_E.shape[0] == 510
    assert float(js.gnorm_opt) < 1e-2 and float(ts.gnorm_opt) < 1e-2
    np.testing.assert_allclose(2 * float(ts.f_opt), 2 * float(js.f_opt),
                               rtol=1e-6)
    # two segment sums per inner matvec, all in float32
    assert len(calls) >= 2 * int(ts.tcg_iters)
    assert set(calls) == {torch.float32}


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, dpgo_tpu_torch, dpgo_tpu_torch.convert, "
        "dpgo_tpu_torch.datasets, dpgo_tpu_torch.quadratic, "
        "dpgo_tpu_torch.ops.segsum, dpgo_tpu_torch.ops.edge_matvec, "
        "dpgo_tpu_torch.ops._build, "
        "dpgo_tpu_torch.solvers.rtr, dpgo_tpu_torch.solvers.chordal; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'dpgo_tpu' or m.startswith('dpgo_tpu.')]; "
        "assert not bad, bad"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)
