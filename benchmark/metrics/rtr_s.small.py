"""solvers/rtr.rtr_solve of a centralized solve, seconds per solve.

The small-graph cell's reading, beside small_solve_s."""

UNIT = "s"


def read(trace):
    return trace.span_mean("central", "rtr")
