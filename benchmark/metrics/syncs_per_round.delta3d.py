"""Host reads of device values per round of the SE(3) delta team: the
round's own (trace.COUNTS "sync.delta.polar", "sync.delta.shrink",
"sync.delta.round"), the certified loop's checks ("sync.delta.check") and
the local RTR steps' ("sync.rtr.tcg", "sync.rtr.control") over the rounds
run ("delta.rounds"); the set-up's solve counts beside the window's
(harness/program_counts.py). At d = 3 the polar's Newton-Schulz checks
and the 20-step tCG's reads are most of them."""

from benchmark.harness import program_counts

UNIT = "syncs"

CAUSES = ("sync.delta.polar", "sync.delta.shrink", "sync.delta.round",
          "sync.delta.check", "sync.rtr.tcg", "sync.rtr.control")


def read(trace):
    return program_counts.per(trace, "delta", CAUSES, "delta.rounds")
