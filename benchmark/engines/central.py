"""The centralized certifiable solve, as chip_smoke.run_slice drives it.

One solve: measurement arrays -> quadratic.from_private_measurements ->
chordal initialization (solvers/chordal.py, its CG in the configuration's
chordal precision) -> the lift by lifted.fixed_stiefel_variable ->
build_quadratic_data (block-Jacobi) -> attach_csr_plans -> rtr_solve to the
configuration's gradient norm, the tCG in the configuration's tCG precision
and the control and iterate in its iterate precision.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch import measurements, quadratic
from dpgo_tpu_torch.ops import edge_matvec, lifted
from dpgo_tpu_torch.solvers import chordal, rtr


class Engine:
    def __init__(self, config: dict, device: torch.device):
        self.cfg, self.device = config, device
        prec = config["precision"]
        self.dtype = getattr(torch, prec["iterate"])
        self.tcg_dtype = getattr(torch, prec["tcg"])
        self.cg_dtype = getattr(torch, prec["chordal_cg"])

    def prepare(self, edges, n: int, d: int):
        """The program's input, built outside the timed solve."""
        return measurements.EdgeArrays(**edges._asdict()), n, d

    def solve(self, inp, spans, X_start=None):
        if X_start is not None:
            raise ValueError("the central engine solves from its chordal "
                             "initialization only")
        edges, n, d = inp
        cfg, dev, dt = self.cfg, self.device, self.dtype
        r = cfg["r"]
        launches = edge_matvec.LAUNCHES
        with spans.span("plan"):
            problem = quadratic.from_private_measurements(
                edges, n=n, d=d, dtype=dt, device=dev)
        with spans.span("chordal"):
            T = chordal.chordal_initialization_arrays(
                edges, n=n, dtype=dt, cg_dtype=self.cg_dtype,
                device=dev, **cfg["chordal"])
            X0 = torch.einsum("rd,nde->nre", lifted.fixed_stiefel_variable(
                d, r, device=dev, dtype=dt), T)
        with spans.span("plan"):
            nbr = torch.zeros((1, r, d + 1), dtype=dt, device=dev)
            qd = quadratic.build_quadratic_data(problem, nbr, r=r,
                                                precond=cfg["precond"])
            qd = quadratic.attach_csr_plans(qd, min_edges=cfg["csr_min_edges"])
        with spans.span("rtr"):
            X, stats = rtr.rtr_solve(qd, X0, inner_dtype=self.tcg_dtype,
                                     **cfg["rtr"])
        return X, stats, qd, launches

    def answer(self, out):
        """(the global iterate, counters), read after the timed solve."""
        X, stats, qd, launches = out
        gnorm = float(stats.gnorm_opt)
        return X, {
            "converged": gnorm < self.cfg["rtr"]["gradnorm_tol"],
            "gradnorm": gnorm,
            "rtr_iters": int(stats.iterations),
            "tcg_iters": int(stats.tcg_iters),
            "edge_matvec_launches": edge_matvec.LAUNCHES - launches,
            "gather_edges": 0 if qd.csr is None else int(qd.off_E.shape[0]),
            "n": qd.n, "w": X.shape[1] * X.shape[2], "dh": X.shape[2],
        }
