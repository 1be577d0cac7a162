"""The float64 chordal initialization of a cold team solve
(solvers/pgo.chordal_initialization) and the lift, seconds per solve;
warm solves have none."""

UNIT = "s"


def read(trace):
    return trace.span_mean("rbcd", "chordal")
