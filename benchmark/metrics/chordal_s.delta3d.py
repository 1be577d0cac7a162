"""The chordal initialization of a solve of the SE(3) delta team
(solvers/chordal.py, its CG in float32: the chordal kernel at d = 3) and
the lift, seconds per solve."""

UNIT = "s"


def read(trace):
    return trace.span_mean("delta", "chordal")
