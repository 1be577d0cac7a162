"""Delta engine rounds of a certified solve of the SE(3) team, every call
of it, per solve."""

UNIT = "rounds"


def read(trace):
    return trace.counter_mean("delta", "rounds")
