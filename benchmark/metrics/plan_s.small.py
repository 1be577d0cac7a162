"""Host planning of a centralized solve, seconds per solve:
quadratic.from_private_measurements, build_quadratic_data and
attach_csr_plans (the benchmark's spans, ended by a synchronize in a
traced run).

The small-graph cell's reading, beside small_solve_s."""

UNIT = "s"


def read(trace):
    return trace.span_mean("central", "plan")
