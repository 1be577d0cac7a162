"""One round of the SE(3) delta team's certified solve, in ms: the time
inside delta.solve_certified over the rounds it ran, over the solves that
the profiler did not slow (all, where it slowed all).

It includes each call's host float64 work (the anchor's reference data,
the answer's assembly and projection, the host certificate), which on the
10,000-pose grid is small beside the round. The round alone is the
program span "delta.round" (benchmark/program_spans.py)."""

UNIT = "ms"


def read(trace):
    if trace.engine != "delta":
        return None
    solves = trace.timed()
    rounds = sum(s["counters"]["rounds"] for s in solves)
    if not rounds:
        return None
    return 1e3 * sum(s["spans"]["rounds"] for s in solves) / rounds
