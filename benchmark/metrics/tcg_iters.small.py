"""tCG iterations of a centralized solve's rtr_solve (its stats.tcg_iters),
per solve.

The small-graph cell's reading, beside small_solve_s."""

UNIT = "iters"


def read(trace):
    return trace.counter_mean("central", "tcg_iters")
