"""Host reads of device values per certified solve, every cause
(trace.COUNTS "sync.*": the chordal PCG's blocks, the trust-region solves'
tCG and control reads, host planning's copies, the certificate's reads and
its refinement's one an iteration) over the certified solves
("certify.solves"); the set-up's warm-up solve counts as one
(harness/program_counts.py)."""

from benchmark.harness import program_counts

UNIT = "syncs"


def read(trace):
    return program_counts.per(trace, "certified", program_counts.ALL_SYNCS,
                              "certify.solves")
