"""Centralized batch PGO: chordal and odometry initialization, solve_pgo and
the GNC-robust solve_robust_pgo.

The counterpart of dpgo_tpu/solvers/pgo.py (reference:
src/DPGO_solver.cpp:220-412), all of it. The variable is at rank r = d (no
lift), matching solvePGO's PoseGraph(id, d, d). Ported beside it: the RBCD
engine in every mode with its distributed GNC (parallel/spmd.py). Still
waiting: the delta engine, the agent protocol layer and the certificate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dpgo_tpu_torch import devices, log, quadratic
from dpgo_tpu_torch.measurements import (
    EdgeArrays,
    RelativeSEMeasurement,
    num_poses_and_dim,
)
from dpgo_tpu_torch.solvers import chordal as chordal_mod
from dpgo_tpu_torch.solvers import rtr as rtr_mod
from dpgo_tpu_torch.robust import RobustCost
from dpgo_tpu_torch.types import (
    ROptParameters,
    RobustCostParameters,
    RobustCostType,
)

_W_TOL = 1e-8


def chordal_initialization(
    measurements: Sequence[RelativeSEMeasurement], *, device
) -> torch.Tensor:
    """Chordal initialization over a measurement list; returns T: (n, d, d+1)
    float64 on `device` (reference: DPGO_solver.cpp:220-269)."""
    d, n = num_poses_and_dim(measurements)
    edges = EdgeArrays.from_measurements(measurements)
    return chordal_mod.chordal_initialization_arrays(edges, n=n, device=device)


def odometry_initialization(
    odometry: Sequence[RelativeSEMeasurement],
    partial_trajectory=None,
    *,
    device,
) -> torch.Tensor:
    """Odometry initialization; returns T: (n, d, d+1) float64 on `device`
    (reference: DPGO_solver.cpp:271-303)."""
    d, n = num_poses_and_dim(odometry)
    edges = EdgeArrays.from_measurements(odometry)
    return chordal_mod.odometry_initialization_arrays(
        edges, n=n, partial_trajectory=partial_trajectory, device=device)


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


@dataclasses.dataclass
class SolveRobustPGOParams:
    """(reference: DPGO_solver.h solveRobustPGOParams)."""

    opt_params: ROptParameters = dataclasses.field(default_factory=ROptParameters)
    robust_params: RobustCostParameters = dataclasses.field(
        default_factory=lambda: RobustCostParameters(cost_type=RobustCostType.GNC_TLS)
    )
    verbose: bool = False


def _residuals_sq(edges: EdgeArrays, T: torch.Tensor) -> torch.Tensor:
    """Batched squared measurement errors
    kappa*||R1 R~ - R2||^2 + tau*||t2 - t1 - R1 t~||^2 on T's device
    (reference: DPGO_utils.cpp:501-507)."""
    def t(x, dt=T.dtype):
        return torch.as_tensor(np.asarray(x), device=T.device).to(dt)

    p1, p2 = t(edges.p1, torch.int64), t(edges.p2, torch.int64)
    R1, t1 = T[p1, :, :-1], T[p1, :, -1]
    R2, t2 = T[p2, :, :-1], T[p2, :, -1]
    rot_err = ((R1 @ t(edges.R) - R2) ** 2).sum(dim=(-2, -1))
    tran_err = ((t2 - t1 - (R1 @ t(edges.t)[..., None])[..., 0]) ** 2).sum(-1)
    return t(edges.kappa) * rot_err + t(edges.tau) * tran_err


def solve_robust_pgo(
    measurements: List[RelativeSEMeasurement],
    params: Optional[SolveRobustPGOParams] = None,
    T0: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[torch.Tensor, List[RelativeSEMeasurement]]:
    """GNC outer loop around solve_pgo (reference: DPGO_solver.cpp:335-412).

    The returned measurement list carries the final GNC weights (the
    reference mutates its input vector; the input list here is left as it
    was). Weights of fixed-weight measurements are untouched, and the loop
    stops as soon as no weight is undecided. Returns (T, measurements).

    device: None (the default) solves on the CUDA card and raises where
    there is none; pass device="cpu" to solve on the CPU."""
    device = devices.resolve(device, "solve_robust_pgo")
    params = SolveRobustPGOParams() if params is None else params
    if params.robust_params.cost_type != RobustCostType.GNC_TLS:
        raise ValueError("solve_robust_pgo needs the GNC_TLS cost")
    measurements = [m.copy() for m in measurements]
    for m in measurements:
        m.weight = 1.0

    def residuals_sq():
        T, _ = solve_pgo(measurements, params.opt_params, T0, device=device)
        edges = EdgeArrays.from_measurements(measurements)
        return edges, _residuals_sq(edges, T)

    _, r_sq = residuals_sq()
    barc = params.robust_params.GNC_barc
    barc_sq = barc * barc
    mu_init = barc_sq / (2 * float(r_sq.max()) - barc_sq)
    if params.verbose:
        log.info("[solve_robust_pgo] initial mu: %s", mu_init)

    if mu_init > 0:
        cost = RobustCost(
            dataclasses.replace(params.robust_params, GNC_init_mu=mu_init)
        )
        for it in range(params.robust_params.GNC_max_iters):
            edges, r_sq = residuals_sq()
            w = cost.weights(torch.sqrt(r_sq)).cpu().numpy()
            free = np.nonzero(~edges.fixed_weight)[0]
            for k in free:
                measurements[k].weight = float(w[k])
            num_out = int((w[free] < _W_TOL).sum())
            num_in = int((w[free] > 1.0 - _W_TOL).sum())
            num_und = len(free) - num_out - num_in
            if params.verbose:
                log.info(
                    f"[solve_robust_pgo] iter {it}: {num_in} inliers, "
                    f"{num_out} outliers, {num_und} undecided"
                )
            if num_und == 0:
                break
            cost.update()

    T, _ = solve_pgo(measurements, params.opt_params, T0, device=device)
    return T, measurements
