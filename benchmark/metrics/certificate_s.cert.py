"""The minimum-eigenvalue certificates of a certified solve
(certify.min_eig_certificate: the deflated Lanczos, the LOBPCG refinement
with one host read an iteration, the Weyl bound), summed over the
staircase's ranks, seconds per solve."""

UNIT = "s"


def read(trace):
    return trace.span_mean("certified", "certificate")
