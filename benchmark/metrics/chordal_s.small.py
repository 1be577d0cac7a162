"""The chordal initialization of a centralized solve (solvers/chordal.py,
its two PCG stages) and the lift, seconds per solve.

The small-graph cell's reading, beside small_solve_s."""

UNIT = "s"


def read(trace):
    return trace.span_mean("central", "chordal")
