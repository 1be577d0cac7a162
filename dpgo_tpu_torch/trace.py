"""The port's spans and counters.

Counters (always on): COUNTS is one collections.Counter for the whole
process. Every host read of a device value on the solvers' paths goes
through read() or fetch(), which add 1 to COUNTS["sync.<cause>"]; loops
whose iterations are not host reads count them under their own names
(chordal.pcg_iters, chordal.pcg_steps). A caller takes the difference of
two snapshots around the work it measures.

  sync.rtr.tcg          the tCG's `done` check, one per tCG iteration
                        (caps above tcg_unroll)
  sync.rtr.control      rtr_solve's loop conditions and its one-problem
                        skip test, RSD's tests, rtr_solve_auto's phase test
  sync.chordal.pcg      the chordal PCG's convergence test, one per block
                        of solvers/chordal.py's BLOCK steps
  sync.spmd.loop        the RBCD run loop's gradient-norm and relative-
                        change tests, one each per round
  sync.spmd.phase       the two-phase driver's switch test
  sync.spmd.select      the selection reads of modes greedy, uniform and
                        async (and the selected agent's activity)
  sync.spmd.check       run_rbcd_spmd's and the GNC driver's checks
  sync.delta.polar      delta_polar's convergence checks
  sync.delta.shrink     the delta RTR step's acceptance checks
  sync.delta.round      the delta run loop's gradient-norm test
  sync.delta.check      run_delta_certified's and run_delta_gnc's checks
  sync.certify.refine   the certificate's LOBPCG refinement's stop test,
                        one per block of certify.REFINE_BLOCK iterations,
                        and its last Rayleigh quotient and residual
  sync.certify          the certificate's other reads and copies
  sync.agent.<cause>    the agent protocol's reads (messages, solve_stats,
                        relative_change, state)
  sync.simulation.central  the in-process drivers' central evaluation
  sync.robust           solve_robust_pgo's residual and weight reads
  sync.plan             host planning's copies of index arrays
  sync.<module>.state   copies of a whole state or answer (spmd's
                        checkpoints and assembly, the drivers' outputs)
  chordal.solves        chordal initializations (two PCG stages each)
  chordal.pcg_iters     PCG iterations of both stages
  chordal.pcg_steps     PCG steps run, a multiple of BLOCK a stage: the
                        iterations and the frozen steps after them
  chordal.graph_replays replays of a stage's captured PCG step (on CUDA)
  rtr.solves            rtr_solve calls
  spmd.rounds           RBCD rounds (_Teams.round calls)
  band_matvec.launches  each hand kernel's launches (ops/_build.launch):
                        one per float32 q_matvec on the card
  tangent_row.launches  one per float32 proj_tangent, apply_precond and
                        rie_hess_vec on the card (2 per tCG iteration)
  edge_matvec.launches  one per float32 q_matvec on the card with CSR plans
  chordal_laplacian.launches  one per float32 chordal PCG step run on the
                        card (a replay counts the launch it holds, the
                        capture none), plus 3 per initialization
  segsum.launches       the standalone segment sum (no path of the package)
  delta.rounds          delta engine rounds (parallel/delta.py, _delta_round)
  delta.folds           on-device anchor folds (_fold_anchor)
  delta.calls           run_delta_certified loops inside a certified solve
  delta.solves          certified solves (delta.solve_certified)
  delta.polar_calls     delta_polar calls (the d = 3 Newton-Schulz polar;
                        the d = 2 closed form counts none)
  delta.polar_steps     the Newton-Schulz steps its loop runs, 3 a trip
                        past the "sync.delta.polar" check
  certify.solves        certified centralized solves
                        (certify.solve_certified)
  certify.calls         min_eig_certificate calls
  certify.lanczos_steps their Lanczos steps (k, or the deflated dimension
                        where that is smaller)
  certify.refine_iters  their LOBPCG refinement iterations (_refine_min),
                        the frozen ones after the stop test left out
  certify.graph_replays replays of a refinement's captured iteration (on
                        CUDA)
  certify.escapes       staircase escapes to the next rank (lift_and_escape)

Spans (off by default): span(name) marks a layer boundary. Off, it returns
one shared no-op context manager: no clock read, no allocation, no
profiler range. After enable() it records (name, parent, start ns, end ns)
on the host clock (time.perf_counter_ns) in memory, parent the index of
the span open around it in the same drain (-1 for none), and opens
torch.profiler.record_function("dpgo/" + name), so that a profiled window
shows the span on the device's timeline. No span synchronizes: a span's
host-clock length covers its device work only where it ends on a host
read. drain() returns the records since the last drain and clears them.
Spans nest on one stack for the process: open them from one thread.

Spans of the delta engine (parallel/delta.py):

  delta.solve           the whole certified solve (solve_certified)
  delta.ref             the host's float64 anchor data (build_delta_ref)
  delta.round           one round (_delta_round), holding
    delta.local_solve   the agents' RTR step (_delta_rtr_step), ending on
                        its shrink loop's last read
    delta.polar         a delta polar projection (delta_polar,
                        delta_polar2), in the round and the local solve
  delta.fold            an anchor fold on the device (_fold_anchor)
  delta.assemble        the answer's transfers, its sum on the host and
                        the projection onto the manifold
  delta.host_certify    the host's float64 cost and gradient norm

Spans of the certified centralized solve (solvers/certify.py), its stages
opened through the span factory solve_certified is given (span by
default), the certificate's parts always through span:

  certify.solve         the whole certified solve (solve_certified)
    certify.plan        the measurement problem, once, and both stages'
                        quadratic data (with CSR plans; with the banded
                        factor)
    certify.chordal     the chordal initialization and the lift to r0
    certify.rtr         the mixed-precision trust-region solve of a rank
    certify.polish      the float64 polish of a rank (certify.polish)
    certify.certificate min_eig_certificate at a rank, holding
      certify.lanczos   the deflation basis, the Lanczos run and its Ritz
                        pair, ending on its residual's read
      certify.refine    the LOBPCG refinement, ending on its last read
      certify.bound     the deflation block, the coupling and the
                        stationarity, ending on its read
    certify.escape      lift_and_escape to the next rank
"""

from __future__ import annotations

import collections
import functools
import time
from typing import List, Tuple

import torch

COUNTS: collections.Counter = collections.Counter()

_on = False
_records: list = []  # [name, parent (absolute index), start ns, end ns]
_base = 0  # absolute index of _records[0]
_stack: List[int] = []  # absolute indices of the open spans


def read(cause: str, t: torch.Tensor):
    """t's one value on the host (bool, int or float by its dtype), counted
    as one host read of `cause`."""
    COUNTS["sync." + cause] += 1
    return t.item()


def fetch(cause: str, t: torch.Tensor, copy: bool = False):
    """t as a numpy array on the host, counted as one host read of `cause`
    (copy=True: a copy on the CPU too)."""
    COUNTS["sync." + cause] += 1
    return t.detach().to("cpu", copy=copy).numpy()


def syncs(counts=None) -> int:
    """The host reads in `counts` (COUNTS by default), every cause."""
    counts = COUNTS if counts is None else counts
    return sum(v for k, v in counts.items() if k.startswith("sync."))


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "index", "range")

    def __init__(self, name: str):
        self.rec = [name, -1, 0, 0]
        self.range = torch.profiler.record_function("dpgo/" + name)

    def __enter__(self):
        if _stack:
            self.rec[1] = _stack[-1]
        self.index = _base + len(_records)
        _records.append(self.rec)
        _stack.append(self.index)
        self.range.__enter__()
        self.rec[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[3] = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack.pop()
        return False


def span(name: str):
    """A context manager around one layer's work (module docstring)."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call inside span(name)."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            if not _on:
                return f(*args, **kwargs)
            with _Span(name):
                return f(*args, **kwargs)
        return inner
    return wrap


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> List[Tuple[str, int, int, int]]:
    """The spans recorded since the last drain, (name, parent, start ns, end
    ns) in the order they opened; parent indexes this list, -1 for none (or
    a span opened before the last drain). A span still open reads end 0."""
    global _records, _base
    out = [(name, parent - _base if parent >= _base else -1, t0, t1)
           for name, parent, t0, t1 in _records]
    _base += len(_records)
    _records = []
    return out
