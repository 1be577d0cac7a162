"""dpgo_tpu_torch — the PyTorch/CUDA port of dpgo_tpu.

Certifiably-correct pose-graph optimization over rank-lifted SE(d) pose
graphs, on PyTorch tensors, with hand-written CUDA kernels for the card
(csrc/, built with nvcc at first use by ops/_build.py). The JAX package
dpgo_tpu beside it is the reference; module paths mirror it.

Ported so far:
  * the centralized lifted solve: measurements, datasets, g2o IO, the
    lifted manifold ops, the quadratic with its block-Jacobi, tridiagonal
    and exact banded preconditioners (ops/block_tridiag.py) and the fused
    edge-matvec kernel, chordal initialization, the Riemannian trust-region
    solver, rtr_solve_auto and solve_pgo;
  * the synchronous RBCD round of parallel/spmd.py (modes 'all' and
    'greedy', Nesterov acceleration with periodic and adaptive restarts,
    elastic membership) on one device, the agents a leading batch axis, with
    the graph partition of parallel/partition.py.

Every function that makes tensors from host data takes a `device`; nothing
here sets a global default device, and nothing draws random numbers.
"""

from dpgo_tpu_torch.types import ROptMethod, ROptParameters
from dpgo_tpu_torch.measurements import EdgeArrays, RelativeSEMeasurement
from dpgo_tpu_torch.io.g2o import read_g2o_file
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.parallel.spmd import (
    SPMDConfig,
    build_spmd_problem,
    initial_state,
    make_run_fn,
    make_step_fn,
    make_two_phase_run_fn,
    run_rbcd_spmd,
)
from dpgo_tpu_torch.solvers.pgo import chordal_initialization, solve_pgo
from dpgo_tpu_torch.solvers.rtr import rtr_solve_auto

__all__ = [
    "EdgeArrays",
    "ROptMethod",
    "ROptParameters",
    "RelativeSEMeasurement",
    "SPMDConfig",
    "build_spmd_problem",
    "chordal_initialization",
    "initial_state",
    "lifted",
    "make_run_fn",
    "make_step_fn",
    "make_two_phase_run_fn",
    "read_g2o_file",
    "rtr_solve_auto",
    "run_rbcd_spmd",
    "solve_pgo",
]

__version__ = "0.1.0"
