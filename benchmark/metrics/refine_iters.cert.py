"""LOBPCG refinement iterations per certificate (certify._refine_min:
trace.COUNTS "certify.refine_iters" over "certify.calls"), each one host
read and ~4 float64 S-actions; its budget is the configuration's
refine_iters. A program that does not count them reads nothing."""

from benchmark.harness import program_counts

UNIT = "iters"


def read(trace):
    return program_counts.per(trace, "certified", ("certify.refine_iters",),
                              "certify.calls")
