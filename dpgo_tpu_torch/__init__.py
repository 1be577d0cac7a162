"""dpgo_tpu_torch — the PyTorch/CUDA port of dpgo_tpu.

Certifiably-correct pose-graph optimization over rank-lifted SE(d) pose
graphs, on PyTorch tensors, with hand-written CUDA kernels for the card
(csrc/, built with nvcc at first use by ops/_build.py). The JAX package
dpgo_tpu beside it is the reference; module paths mirror it.

Ported so far: the centralized lifted solve — measurements, datasets, g2o
IO, the lifted manifold ops, the quadratic with its block-Jacobi
preconditioner and the CSR segment-sum kernel, chordal initialization, the
Riemannian trust-region solver and solve_pgo.

Every function that makes tensors from host data takes a `device`; nothing
here sets a global default device, and nothing draws random numbers.
"""

from dpgo_tpu_torch.types import ROptMethod, ROptParameters
from dpgo_tpu_torch.measurements import EdgeArrays, RelativeSEMeasurement
from dpgo_tpu_torch.io.g2o import read_g2o_file
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.solvers.pgo import chordal_initialization, solve_pgo

__all__ = [
    "EdgeArrays",
    "ROptMethod",
    "ROptParameters",
    "RelativeSEMeasurement",
    "chordal_initialization",
    "lifted",
    "read_g2o_file",
    "solve_pgo",
]

__version__ = "0.1.0"
