"""One synchronous RBCD round (parallel/spmd.py, _round_body through the
run function), in ms: the time inside run() over the rounds it ran, over
the solves that the profiler did not slow (all, where it slowed all)."""

UNIT = "ms"


def read(trace):
    if trace.engine != "rbcd":
        return None
    solves = trace.timed()
    rounds = sum(s["counters"]["rounds"] for s in solves)
    if not rounds:
        return None
    return 1e3 * sum(s["spans"]["rounds"] for s in solves) / rounds
