"""Solver parameters and the reference's hard-coded constants.

The counterpart of the part of dpgo_tpu/types.py that the centralized solve
and the graph partition need (reference: include/DPGO/DPGO_types.h:44-120,
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


PRIOR_KAPPA: float = 1.0e4  # PoseGraph.cpp:17
PRIOR_TAU: float = 1.0e2  # PoseGraph.cpp:18
PRECONDITIONER_SHIFT: float = 1.0e-1  # PoseGraph.cpp:603


class PoseID(NamedTuple):
    """Unique pose = (robot_id, frame_id) (reference: DPGO_types.h:110-120).
    Hashable and ordered like the reference's ComparePoseID."""

    robot_id: int
    frame_id: int
