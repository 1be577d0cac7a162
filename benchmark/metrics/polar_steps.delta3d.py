"""Newton-Schulz steps per call of the delta polar (parallel/delta.py,
delta_polar: trace.COUNTS "delta.polar_steps" over "delta.polar_calls"),
3 a trip of its loop: 0 where every block was already on the manifold, up
to 18 at its cap. A program that does not count them reads nothing."""

from benchmark.harness import program_counts

UNIT = "steps"


def read(trace):
    return program_counts.per(trace, "delta", ("delta.polar_steps",),
                              "delta.polar_calls")
