"""Float32 chordal PCG iterations per solve of the SE(3) delta team, both
stages (trace.COUNTS "chordal.pcg_iters" over "chordal.solves", one
initialization a solve; the set-up's warm-up solve counts as one,
harness/program_counts.py). Beside chordal_s.delta3d, it tells less work
from faster work in the initialization."""

from benchmark.harness import program_counts

UNIT = "iters"


def read(trace):
    return program_counts.per(trace, "delta", ("chordal.pcg_iters",),
                              "chordal.solves")
