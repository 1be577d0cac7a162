"""The comparison that decides `correct`.

Every solve of the window is judged once the window has closed: the plain
reference (benchmark/reference/objective.py) recomputes, in float64 from
the solve's own edges, the Riemannian gradient norm of the iterate the
program returned and how far its rotation blocks are from orthonormal.
A solve fails when either exceeds its limit in the configuration file, or
when the program itself reports that it missed its tolerance within its
cap. The run is correct when no solve fails.
"""

from __future__ import annotations

import math
import sys

from benchmark.reference import objective


def _finite(x: float) -> float:
    return x if math.isfinite(x) else sys.float_info.max


def judge_solve(edges, X, counters: dict, limits: dict) -> dict:
    """The reference's readings of one answer, and whether it passes."""
    r = objective.readings(edges, X)
    r = {k: _finite(v) for k, v in r.items()}
    r["missed_tolerance"] = 0 if counters["converged"] else 1
    r["ok"] = all(r[name] <= limit for name, limit in limits.items())
    return r


def worst(readings: list, limits: dict) -> dict:
    """Each compared number's worst reading over the solves, beside its
    limit."""
    return {name: {"value": max((r[name] for r in readings), default=0.0),
                   "limit": limit}
            for name, limit in limits.items()}


def summary(solves: list) -> dict:
    """Each numeric counter of the engine, per solve (an earlier line)."""
    keys = [k for k, v in solves[0]["counters"].items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)] \
        if solves else []
    return {k: [s["counters"][k] for s in solves] for k in keys}
