"""The local tCG's host reads per round of the SE(3) delta team
(trace.COUNTS "sync.rtr.tcg" over "delta.rounds"): one per tCG iteration
past the unrolled ones, under the cap of 20; the set-up's solve counts
beside the window's (harness/program_counts.py)."""

from benchmark.harness import program_counts

UNIT = "syncs"


def read(trace):
    return program_counts.per(trace, "delta", ("sync.rtr.tcg",),
                              "delta.rounds")
