"""The chordal initialization of a certified solve (solvers/chordal.py,
its two PCG stages, the kernel at d = 3) and the lift to r0, seconds per
solve."""

UNIT = "s"


def read(trace):
    return trace.span_mean("certified", "chordal")
