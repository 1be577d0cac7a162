"""Host planning of a team solve, seconds per solve:
spmd.build_spmd_problem, initial_state and make_two_phase_run_fn (the
round-invariant data and the banded factor)."""

UNIT = "s"


def read(trace):
    return trace.span_mean("rbcd", "plan")
