"""Synchronous accelerated RBCD by a robot team, as chip_smoke.rbcd_team and
phase_rbcd drive it.

One solve: the team's measurement list -> spmd.build_spmd_problem (the
partition into num_agents robots, stacked and padded) -> the float64
chordal initialization (solvers/pgo.chordal_initialization) and the lift,
or a given start iterate -> spmd.initial_state -> make_two_phase_run_fn ->
run(state0, max_rounds, gradnorm_tol). The answer is the global iterate
assembled from the agents' blocks of the final state.
"""

from __future__ import annotations

import torch

from dpgo_tpu_torch import measurements
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.parallel import spmd
from dpgo_tpu_torch.solvers import pgo


class Engine:
    def __init__(self, config: dict, device: torch.device):
        self.cfg, self.device = config, device
        prec = config["precision"]
        self.dtype = getattr(torch, prec["iterate"])
        self.spmd_cfg = spmd.SPMDConfig(rtr_inner_dtype=prec["tcg"],
                                        **config["spmd"])

    def prepare(self, edges, n: int, d: int):
        """The program's input, built outside the timed solve."""
        return measurements.EdgeArrays(**edges._asdict()).to_measurements(), n, d

    def solve(self, inp, spans, X_start=None):
        meas, n, d = inp
        cfg, dev = self.cfg, self.device
        r = cfg["r"]
        with spans.span("plan"):
            problem, ranges = spmd.build_spmd_problem(
                meas, n, cfg["num_agents"], r, dtype=self.dtype, device=dev)
        if X_start is None:
            with spans.span("chordal"):
                T = pgo.chordal_initialization(meas, device=dev)
                X_start = torch.einsum("rd,nde->nre",
                                       lifted.fixed_stiefel_variable(
                                           d, r, device=dev), T)
        with spans.span("plan"):
            state0 = spmd.initial_state(problem, X_start, ranges, device=dev)
            run = spmd.make_two_phase_run_fn(problem, self.spmd_cfg,
                                             device=dev)
        with spans.span("rounds"):
            state, metrics, rounds = run(state0, cfg["max_rounds"],
                                         cfg["gradnorm_tol"])
        return state, metrics, rounds, ranges, run.switch_round

    def answer(self, out):
        """(the global iterate, counters), read after the timed solve."""
        state, metrics, rounds, ranges, switch = out
        X = torch.cat([state.X[a, : e - s] for a, (s, e) in enumerate(ranges)])
        gnorm = float(metrics.gradnorm)
        return X, {"converged": gnorm < self.cfg["gradnorm_tol"],
                   "gradnorm": gnorm, "rounds": rounds,
                   "switch_round": switch}
