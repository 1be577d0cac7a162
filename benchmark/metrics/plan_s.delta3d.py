"""Host planning of a solve of the SE(3) delta team, seconds per solve:
spmd.build_spmd_problem (the partition into robots, stacked and padded)."""

UNIT = "s"


def read(trace):
    return trace.span_mean("delta", "plan")
