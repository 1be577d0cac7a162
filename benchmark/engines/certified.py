"""SE-Sync's certified centralized solve (certify.solve_certified): the
Riemannian staircase with its float64 polish and minimum-eigenvalue
certificate.

One solve: the measurement arrays -> certify.solve_certified, which
assembles the problem once (quadratic.from_private_measurements), lifts the
chordal initialization (its CG in the chordal precision) to rank r and, at
each rank, runs rtr_solve to the configuration's loose gradient norm (tCG
in the tCG precision, block-Jacobi, CSR plans), the polish to the
certificate's tolerance in the polish precision, then min_eig_certificate
in the certificate precision over the exact banded factor; where the
certificate fails, lift_and_escape to r + 1, up to r_max. The program's
stages open the benchmark's spans plan, chordal, rtr, polish and
certificate, summed over the ranks, inside the program's own.

After the timed solve the plain reference of the certificate
(benchmark/reference/certificate.py) rereads the answer: a solve counts as
converged only where the polish reached its tolerance, the program
certified, and the reference agrees (its own Lanczos finds no eigenvalue
below -eta, and the program's Ritz pair and stationarity are what the
reference computes for them).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import certificate as reference
from dpgo_tpu_torch import measurements, trace
from dpgo_tpu_torch.solvers import certify
# a program without the certified solve fails here, before any work; the
# engine calls it through the module, where the tests plant their faults
from dpgo_tpu_torch.solvers.certify import solve_certified  # noqa: F401

# the program's stage spans -> the benchmark's; certify.solve and
# certify.escape are inside the run's own "solve" span
SPANS = {"certify.plan": "plan", "certify.chordal": "chordal",
         "certify.rtr": "rtr", "certify.polish": "polish",
         "certify.certificate": "certificate"}


class Engine:
    def __init__(self, config: dict, device: torch.device):
        self.cfg, self.device = config, device
        self.precision = {k: getattr(torch, v)
                          for k, v in config["precision"].items()}

    def prepare(self, edges, n: int, d: int):
        """The program's input, built outside the timed solve; the raw
        edges are kept for the reference."""
        return measurements.EdgeArrays(**edges._asdict()), n, d, edges

    def solve(self, inp, spans, X_start=None):
        if X_start is not None:
            raise ValueError("the certified engine solves from its chordal "
                             "initialization only")
        arrays, n, d, edges = inp
        cfg = self.cfg
        launches = trace.COUNTS["edge_matvec.launches"]

        @contextlib.contextmanager
        def stage(name):
            # the program's own span (off unless trace.enable()), and the
            # benchmark's for the stages it times
            bench = spans.span(SPANS[name]) if name in SPANS \
                else contextlib.nullcontext()
            with trace.span(name), bench:
                yield

        res = certify.solve_certified(
            arrays, n, d, r0=cfg["r"], r_max=cfg["r_max"],
            precision=self.precision, chordal_settings=cfg["chordal"],
            precond=cfg["precond"], csr_min_edges=cfg["csr_min_edges"],
            rtr_settings=cfg["rtr"], polish_settings=cfg["polish"],
            certificate=cfg["certificate"], spans=stage, device=self.device)
        return res, edges, launches

    def answer(self, out):
        """(the global iterate, counters), read after the timed solve; the
        reference's readings are among the counters."""
        res, edges, launches = out
        cert = res.certificate
        gnorm = float(res.stages[-1]["polish"].gnorm_opt)
        ref = reference.readings(edges, res.X, cert.eigvec, cert.ritz,
                                 cert.eig_residual, cert.stationarity)
        agrees = reference.agrees(ref, self.cfg["certificate"]["eta"])
        polished = gnorm < self.cfg["polish"]["gradnorm_tol"]
        stages = res.stages
        return res.X, dict({
            "converged": polished and cert.certified and agrees,
            "gradnorm": gnorm,
            "certified": int(cert.certified),
            "agrees": int(agrees),
            "rank": res.r, "escapes": res.escapes,
            "lambda_min": cert.lambda_min,
            "lambda_min_lower": cert.lambda_min_lower,
            "ritz": cert.ritz, "eig_residual": cert.eig_residual,
            "lanczos_steps": sum(s["certificate"].lanczos_steps
                                 for s in stages),
            "refine_iters": sum(s["certificate"].refine_iters
                                for s in stages),
            "tcg_iters": sum(int(s["rtr"].tcg_iters) for s in stages),
            "polish_tcg_iters": sum(int(s["polish"].tcg_iters)
                                    for s in stages),
            "polish_iters": sum(int(s["polish"].iterations)
                                for s in stages),
            "edge_matvec_launches":
                trace.COUNTS["edge_matvec.launches"] - launches,
        }, **ref)
