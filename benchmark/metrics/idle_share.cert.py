"""The card's idle share in the profiled certified solves: 1 - the union of
the device's intervals over the solves' wall time, in %. The profiler
slows the host, so this is an upper bound."""

UNIT = "%"


def read(trace):
    return trace.idle_percent("certified")
