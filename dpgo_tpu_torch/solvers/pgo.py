"""Centralized batch PGO: chordal initialization and solve_pgo.

The counterpart of the centralized part of dpgo_tpu/solvers/pgo.py
(reference: src/DPGO_solver.cpp:220-333). The variable is at rank r = d (no
lift), matching solvePGO's PoseGraph(id, d, d). The GNC-robust solve waits
for the port of robust.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dpgo_tpu_torch import devices, quadratic
from dpgo_tpu_torch.measurements import (
    EdgeArrays,
    RelativeSEMeasurement,
    num_poses_and_dim,
)
from dpgo_tpu_torch.solvers import chordal as chordal_mod
from dpgo_tpu_torch.solvers import rtr as rtr_mod
from dpgo_tpu_torch.types import ROptParameters


def chordal_initialization(
    measurements: Sequence[RelativeSEMeasurement], *, device
) -> torch.Tensor:
    """Chordal initialization over a measurement list; returns T: (n, d, d+1)
    float64 on `device` (reference: DPGO_solver.cpp:220-269)."""
    d, n = num_poses_and_dim(measurements)
    edges = EdgeArrays.from_measurements(measurements)
    return chordal_mod.chordal_initialization_arrays(edges, n=n, device=device)


def solve_pgo(
    measurements: Sequence[RelativeSEMeasurement],
    params: ROptParameters = ROptParameters(),
    T0: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[torch.Tensor, rtr_mod.RTRStats]:
    """Centralized PGO at rank r = d: chordal init (unless T0 is given) + RTR
    (reference: DPGO_solver.cpp:305-333). Returns (T: (n, d, d+1), stats),
    float64 on `device`.

    device: None (the default) solves on the CUDA card and raises where
    there is none; pass device="cpu" to solve on the CPU."""
    device = devices.resolve(device, "solve_pgo")
    d, n = num_poses_and_dim(measurements)
    if T0 is None:
        T = chordal_initialization(measurements, device=device)
    else:
        T = torch.as_tensor(np.asarray(T0), dtype=torch.float64, device=device)
    if T.shape != (n, d, d + 1):
        raise ValueError(f"T0 must be ({n}, {d}, {d + 1}), got {tuple(T.shape)}")

    edges = EdgeArrays.from_measurements(measurements)
    problem = quadratic.from_private_measurements(edges, n=n, d=d, device=device)
    nbr = torch.zeros((1, d, d + 1), dtype=torch.float64, device=device)
    qd = quadratic.build_quadratic_data(problem, nbr, r=d)
    return rtr_mod.optimize(qd, T, params)
