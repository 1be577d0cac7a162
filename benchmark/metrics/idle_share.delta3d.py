"""The card's idle share in the profiled solves of the SE(3) delta team:
1 - the union of the device's intervals over the solves' wall time, in %.
The profiler slows the host, so this is an upper bound."""

UNIT = "%"


def read(trace):
    return trace.idle_percent("delta")
