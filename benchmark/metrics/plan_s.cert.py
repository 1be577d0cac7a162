"""Host planning of a certified solve, seconds per solve: the measurement
problem (quadratic.from_private_measurements, once a solve) and both
stages' quadratic data (block-Jacobi with CSR plans for the trust-region
solves, the exact banded factor for the certificate), in the program's
certify.plan stage (the benchmark's span, ended by a synchronize in a
traced run)."""

UNIT = "s"


def read(trace):
    return trace.span_mean("certified", "plan")
