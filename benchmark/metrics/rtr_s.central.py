"""solvers/rtr.rtr_solve of a centralized solve, seconds per solve."""

UNIT = "s"


def read(trace):
    return trace.span_mean("central", "rtr")
