"""RBCD rounds of a team solve (the run function's round count), per solve."""

UNIT = "rounds"


def read(trace):
    return trace.counter_mean("rbcd", "rounds")
