"""Solver parameters and the reference's hard-coded constants.

The counterpart of the part of dpgo_tpu/types.py that the solvers, the
robust costs and the graph partition need (reference:
include/DPGO/DPGO_types.h:33-120, include/DPGO/DPGO_robust.h:20-77,
PoseGraph.cpp:17-18,603). The agent-protocol types wait for the port of the
protocol layer.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple


class ROptMethod(enum.Enum):
    """Local Riemannian solver (reference: DPGO_types.h:47-52)."""

    RTR = "RTR"
    RGD = "RGD"


class InitializationMethod(enum.Enum):
    """Local trajectory initialization (reference: DPGO_types.h:33-37)."""

    Odometry = "Odometry"
    Chordal = "Chordal"
    GNC_TLS = "GNC_TLS"


class RobustCostType(enum.Enum):
    """Robust cost kernels (reference: DPGO_robust.h:24-31)."""

    L2 = "L2"
    L1 = "L1"
    TLS = "TLS"
    Huber = "Huber"
    GM = "GM"
    GNC_TLS = "GNC_TLS"


@dataclasses.dataclass(frozen=True)
class ROptParameters:
    """Riemannian optimization settings (reference: DPGO_types.h:44-86).

    Defaults match the reference exactly: per-RBCD-step RTR budget of 3 outer
    iterations / 50 tCG inner iterations, |grad| tolerance 1e-2, initial
    trust-region radius 100.
    """

    method: ROptMethod = ROptMethod.RTR
    verbose: bool = False
    gradnorm_tol: float = 1e-2
    RGD_stepsize: float = 1e-3
    RGD_use_preconditioner: bool = True
    RTR_iterations: int = 3
    RTR_tCG_iterations: int = 50
    RTR_initial_radius: float = 100.0


@dataclasses.dataclass(frozen=True)
class RobustCostParameters:
    """Robust cost parameters (reference: DPGO_robust.h:20-77).

    GNC defaults match the reference: maxIters=20, barc=5.0, muStep=1.4,
    initMu=1e-4.
    """

    cost_type: RobustCostType = RobustCostType.L2
    GNC_max_iters: int = 20
    GNC_barc: float = 5.0
    GNC_mu_step: float = 1.4
    GNC_init_mu: float = 1e-4
    huber_threshold: float = 3.0
    TLS_threshold: float = 10.0


PRIOR_KAPPA: float = 1.0e4  # PoseGraph.cpp:17
PRIOR_TAU: float = 1.0e2  # PoseGraph.cpp:18
PRECONDITIONER_SHIFT: float = 1.0e-1  # PoseGraph.cpp:603


class PoseID(NamedTuple):
    """Unique pose = (robot_id, frame_id) (reference: DPGO_types.h:110-120).
    Hashable and ordered like the reference's ComparePoseID."""

    robot_id: int
    frame_id: int
