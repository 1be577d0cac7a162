"""The mixed-precision trust-region solves of a certified solve (rtr_solve
to the loose gradient norm, float32 tCG), summed over the staircase's
ranks, seconds per solve."""

UNIT = "s"


def read(trace):
    return trace.span_mean("certified", "rtr")
