"""The float64 polishes of a certified solve (certify.polish: rtr_solve to
the certificate's tolerance, its tCG in float64), summed over the
staircase's ranks, seconds per solve."""

UNIT = "s"


def read(trace):
    return trace.span_mean("certified", "polish")
