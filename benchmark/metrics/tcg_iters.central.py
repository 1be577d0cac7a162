"""tCG iterations of a centralized solve's rtr_solve (its stats.tcg_iters),
per solve."""

UNIT = "iters"


def read(trace):
    return trace.counter_mean("central", "tcg_iters")
