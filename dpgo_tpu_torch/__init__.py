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
  * the residual form of the objective and the trust-region solver's
    residual-form control, RGD and RSD, odometry initialization;
  * the RBCD engine of parallel/spmd.py (modes 'all', 'greedy', 'uniform'
    and 'async', Nesterov acceleration with periodic and adaptive restarts,
    elastic membership, checkpoints) on one device, the agents a leading
    batch axis, with the graph partition of parallel/partition.py;
  * the robust costs (robust.py) with distributed GNC (run_rbcd_gnc) and the
    centralized GNC solve (solve_robust_pgo);
  * the anchored delta engine (parallel/delta.py: run_delta_certified,
    run_delta_gnc, host_certify) and the dual certificate with the
    Riemannian staircase (solvers/certify.py).

Every function that makes tensors from host data takes a `device`, and
nothing here sets a global default device. Random draws come from an
explicit torch.Generator.
"""

from dpgo_tpu_torch.types import (
    InitializationMethod,
    ROptMethod,
    ROptParameters,
    RobustCostParameters,
    RobustCostType,
)
from dpgo_tpu_torch.measurements import EdgeArrays, RelativeSEMeasurement
from dpgo_tpu_torch.io.g2o import read_g2o_file
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.parallel.spmd import (
    SPMDConfig,
    build_spmd_problem,
    edge_weight_table,
    gnc_reweight,
    initial_state,
    load_state,
    make_run_fn,
    make_step_fn,
    make_two_phase_run_fn,
    run_rbcd_gnc,
    run_rbcd_spmd,
    save_state,
)
from dpgo_tpu_torch.robust import RobustCost
from dpgo_tpu_torch.solvers.pgo import (
    SolveRobustPGOParams,
    chordal_initialization,
    odometry_initialization,
    solve_pgo,
    solve_robust_pgo,
)
from dpgo_tpu_torch.solvers.certify import (
    min_eig_certificate,
    solve_pgo_staircase,
)
from dpgo_tpu_torch.solvers.rtr import rtr_solve_auto

__all__ = [
    "EdgeArrays",
    "InitializationMethod",
    "ROptMethod",
    "ROptParameters",
    "RelativeSEMeasurement",
    "RobustCost",
    "RobustCostParameters",
    "RobustCostType",
    "SPMDConfig",
    "SolveRobustPGOParams",
    "build_spmd_problem",
    "chordal_initialization",
    "edge_weight_table",
    "gnc_reweight",
    "initial_state",
    "lifted",
    "load_state",
    "make_run_fn",
    "make_step_fn",
    "make_two_phase_run_fn",
    "min_eig_certificate",
    "odometry_initialization",
    "read_g2o_file",
    "rtr_solve_auto",
    "run_rbcd_gnc",
    "run_rbcd_spmd",
    "save_state",
    "solve_pgo",
    "solve_pgo_staircase",
    "solve_robust_pgo",
]

__version__ = "0.1.0"
