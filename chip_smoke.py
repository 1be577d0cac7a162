#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dpgo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each, in order; any failure exits non-zero before the last
line:
  1. device: requires CUDA; prints the card and nvidia-smi's name and power
     limit, and turns TF32 off.
  2. build: compiles the CUDA kernels from dpgo_tpu_torch/csrc with nvcc and
     prints ptxas's registers and spills per kernel.
  3. kernel: each kernel against its plain version, two runs with identical
     bits required:
     - the CSR segment sum against index_add_ at the shapes of
       tests/test_pallas_segsum.py, a hotspot/empty-rows case and the
       slice's own plans (n = 100,000 rows, m = 92,595 edges, w = 15);
     - the fused edge matvec against edge_matvec_reference at w = 15, 20 and
       36, a row with 1,000 edges among empty rows, and the slice's plans;
     then, at the slice's shape, each kernel's device time per call in turns
     with its plain version, the unfused sequence the fused kernel replaces,
     torch.segment_reduce and index_add_: cold, rotating over copies of the
     inputs so that each call reads them from HBM (the kernels line's
     numbers, as the byte bound assumes), and warm, in L2.
  4. slice: the centralized lifted solve on synthesize_city2d(100000, seed=0),
     d = 2, r = 5 — chordal init (float32 CG, tol 1e-6), lift, block-Jacobi,
     CSR plans, RTR with float32 tCG and float64 control to gradnorm < 1e-2 —
     once to warm up and three times timed. The last run must launch the
     fused kernel at least once per tCG iteration and land on the JAX
     package's cost within 1e-6 relative; a small graph must give the same
     cost on the card as on the CPU.
  5. auto: the centralized solve through rtr_solve_auto on
     synthesize_grid3d(3375, seed=0), d = 3, r = 5, float32 tCG: a
     one-iteration block-Jacobi probe, then the escalation to the exact RCM
     banded factor, with CSR plans attached, so the fused kernel runs in
     both phases. Prints the RCM bandwidth, s, nb, the factor's build time,
     each phase's RTR and tCG iterations and the kernel's launches; 2f must
     land within 1e-6 relative of the JAX package's value. Both kernels are
     held against their plain versions on this path's plans (w = 20).
  6. rbcd: the synchronous RBCD engine (parallel/spmd.py) at full size:
     synthesize_grid3d(10000, seed=1) in 8 agents of 1,250 poses at r = 5,
     from the lifted float64 chordal init, with bench.run_distributed's
     accelerator configuration through make_two_phase_run_fn, to gradnorm
     < 1e-2 (at most 2,000 rounds): one warm-up and three timed runs. Prints
     the preconditioner that 'auto' chose, the stage times, the rounds, ms
     per round, the phase-switch round, the final gradnorm and team cost
     (within 1e-5 relative of the JAX package's); then one more run under
     torch.profiler (device busy time, idle share, device ops per round,
     the top device ops), and the device time of one project_lifted (SVD)
     and project_lifted_ns_mixed call at the team's shape.
  7. rbcd-f64: the same team in float64 throughout, 20 rounds of
     make_run_fn in mode 'all' and 20 in mode 'greedy': each team cost and
     gradnorm within 1e-6 relative of the JAX package's.
Then a JSON line with the kernels' numbers and, last, the JSON result line.

Imports nothing of JAX or dpgo_tpu.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from dpgo_tpu_torch import datasets, quadratic
from dpgo_tpu_torch.ops import _build, block_tridiag, edge_matvec, lifted, segsum
from dpgo_tpu_torch.parallel import spmd
from dpgo_tpu_torch.solvers import chordal, rtr
from dpgo_tpu_torch.solvers.pgo import chordal_initialization

# 2·f_opt of the slice from the JAX package on the CPU (x64), same graph and
# settings (float32 chordal CG at tol 1e-6 / maxiter 1000, block-Jacobi,
# rtr_solve(gradnorm_tol=1e-2, initial_radius=100, max_iterations=100,
# max_inner=200, inner_dtype=float32)); 4 RTR / 406 tCG iterations there.
# Produced by (JAX_PLATFORMS=cpu, jax_enable_x64 on):
#   edges, n, _ = dpgo_tpu.datasets.synthesize_city2d(100000, seed=0)
#   problem = quadratic.from_private_measurements(edges, n=n, d=2)
#   T = chordal.chordal_initialization_arrays(edges, n=n,
#         cg_dtype=jnp.float32, tol=1e-6, maxiter=1000)
#   X0 = jnp.einsum("rd,nde->nre", lifted.fixed_stiefel_variable(2, 5), T)
#   qd = quadratic.build_quadratic_data(problem, jnp.zeros((1, 5, 3)), r=5)
#   X, st = rtr.rtr_solve(qd, X0, 1e-2, 100.0, max_iterations=100,
#         max_inner=200, inner_dtype=jnp.float32);  print(2 * st.f_opt)
EXPECTED_2F = 3232.3695392369
COST_RTOL = 1e-6
SEGSUM_ATOL = 5e-5  # tests/test_pallas_segsum.py, scaled by row magnitude
NUM_POSES, D, R = 100_000, 2, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3 rate and dense fp32 peak
FP32_FLOP_PER_S = 67e12
COLD_COPIES = 10  # input copies in rotation, > 250 MB against the 50 MB L2
SOLVE = dict(gradnorm_tol=1e-2, initial_radius=100.0, max_iterations=100,
             max_inner=200, inner_dtype=torch.float32)

# The auto phase: 2·f_opt of the JAX package on the CPU (x64), same graph
# and settings; 4 RTR / 24 tCG iterations there (1 Jacobi, then banded with
# bandwidth 215, s = 216, nb = 16). Produced by (JAX_PLATFORMS=cpu,
# jax_enable_x64 on):
#   edges, n, _ = dpgo_tpu.datasets.synthesize_grid3d(3375, seed=0)
#   problem = quadratic.from_private_measurements(edges, n=n, d=3)
#   T = chordal.chordal_initialization_arrays(edges, n=n,
#         cg_dtype=jnp.float32, tol=1e-6, maxiter=1000)
#   X0 = jnp.einsum("rd,nde->nre", lifted.fixed_stiefel_variable(3, 5), T)
#   X, st = rtr.rtr_solve_auto(problem, X0, gradnorm_tol=1e-2,
#         initial_radius=100.0, max_iterations=100, max_inner=200,
#         probe_iterations=1, inner_dtype=jnp.float32);  print(2 * st.f_opt)
# (synthesize_city2d(10000)'s RCM bandwidth is 722: s * dh = 2184 exceeds
# the 1024 cap, so its escalation falls back to block-Jacobi in both
# packages and never builds the banded factor.)
AUTO_POSES, AUTO_D, AUTO_EXPECTED_2F = 3375, 3, 661.5151117906
AUTO_SOLVE = dict(SOLVE, probe_iterations=1)

# The rbcd phases: the JAX package on the CPU (x64) with the same team, init
# and configuration. Produced by (JAX_PLATFORMS=cpu, jax_enable_x64 on):
#   edges, n, _ = dpgo_tpu.datasets.synthesize_grid3d(10000, seed=1)
#   meas = edges.to_measurements(); T = chordal_initialization(meas)
#   problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=8, r=5)
#   X0 = np.einsum("rd,nde->nre", lifted.fixed_stiefel_variable(3, 5), T)
#   state0 = spmd.initial_state(problem, X0, ranges)
#   run = spmd.make_two_phase_run_fn(problem, RBCD_CFG)
#   state, m, rounds = run(state0, 2000, 1e-2);  print(rounds, m.cost)
# -> 133 rounds, gradnorm 9.9592068570e-03; and, for the float64 checks,
#   run = spmd.make_run_fn(problem, replace(RBCD_CFG, rtr_inner_dtype=None,
#         mode=mode));  state, m, rounds = run(state0, 20, 0.0)
RBCD_POSES, RBCD_AGENTS, RBCD_TOL = 10_000, 8, 1e-2
RBCD_CFG = spmd.SPMDConfig(
    mode="all", acceleration=True, rtr_iterations=1,
    rtr_gradnorm_tol=RBCD_TOL / (2 * np.sqrt(RBCD_AGENTS)),
    rtr_inner_dtype="float32", adaptive_restart=True,
    restart_interval=10**6, nesterov_n=5, precond="auto")
RBCD_EXPECTED_COST, RBCD_JAX_ROUNDS, RBCD_COST_RTOL = 1957.1466309025, 133, 1e-5
F64_EXPECTED = {  # mode -> (team cost, gradnorm) after 20 rounds
    "all": (1957.198579109727, 3.805122861325e-01),
    "greedy": (1957.922533162967, 9.283203689053e+00),
}
F64_RTOL = 1e-6


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(
        f"device: {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}",
        flush=True,
    )
    print(smi_line, flush=True)
    return torch.device("cuda", 0), smi_line


def phase_build():
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {so}", flush=True)
    for name, regs, st, ld in _build.ptxas_report():
        print(f"ptxas: {name} registers={regs} spill_stores={st} "
              f"spill_loads={ld}", flush=True)


def check_segsum(C, plan):
    """Segment-sum kernel vs plain on one input; returns the max abs error."""
    out = segsum.segment_sum_csr(C, plan)
    again = segsum.segment_sum_csr(C, plan)
    ref = segsum.segment_sum_reference(C, plan)
    mag = segsum.segment_sum_reference(C.abs(), plan)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail("segsum kernel: two runs differ")
    err = (out - ref).abs()
    if not bool(torch.all(err <= SEGSUM_ATOL * torch.clamp(mag, min=1.0))):
        fail(f"segsum kernel disagrees with index_add_: max err "
             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_fused(csr, V, out0):
    """Fused edge-matvec kernel vs edge_matvec_reference on one input, within
    SEGSUM_ATOL scaled by the row magnitude (|out0| + the plain edge term on
    |V| and |E|); returns the max abs error."""
    out = edge_matvec.edge_matvec(out0.clone(), V, csr)
    again = edge_matvec.edge_matvec(out0.clone(), V, csr)
    ref = edge_matvec.edge_matvec_reference(out0.clone(), V, csr)
    abs_csr = dataclasses.replace(csr, E_by_j=csr.E_by_j.abs(),
                                  E_by_i=csr.E_by_i.abs())
    mag = out0.abs() + edge_matvec.edge_matvec_reference(
        torch.zeros_like(out0), V.abs(), abs_csr).abs()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail("edge-matvec kernel: two runs differ")
    err = (out - ref).abs()
    if not bool(torch.all(err <= SEGSUM_ATOL * torch.clamp(mag, min=1.0))):
        fail(f"edge-matvec kernel disagrees with its plain version: max err "
             f"{float(err.max())}")
    return float(err.max())


def random_csr(rng, n, m, dh, dev, hot=None):
    """Random edges i -> j with float32 (dh, dh) blocks as CSR plans; with
    `hot`, every edge points into row `hot` from the first tenth of the
    rows, so one row holds all ->j edges and most rows are empty."""
    if hot is None:
        i, j = rng.integers(0, n, m), rng.integers(0, n, m)
    else:
        i, j = rng.integers(0, max(1, n // 10), m), np.full(m, hot)
    E = torch.as_tensor(rng.standard_normal((m, dh, dh)), dtype=torch.float32,
                        device=dev)
    return quadratic.make_csr_plans(torch.as_tensor(i, device=dev),
                                    torch.as_tensor(j, device=dev), E, n)


def randn(rng, shape, dev):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device=dev)


def device_ms(fns, reps=20, samples=15):
    """Device time per call of each function in `fns` (name -> list of
    callables, called in rotation), sampled in turns (forward, then
    backward order): the median over `samples` of the CUDA-event time of
    `reps` back-to-back calls. Before each sample a sleep kernel holds the
    stream while the host enqueues the calls, so the host's launch cost
    stays out of the time.

    With one callable a function's inputs stay in the 50 MB L2 from call to
    call (warm). With COLD_COPIES callables, each on its own copy of the
    inputs, the other copies' traffic evicts a copy from L2 before it comes
    round again, so every call reads its inputs from HBM, as bound_ms
    assumes (cold)."""
    def enqueue(calls):
        for i in range(reps):
            calls[i % len(calls)]()

    for calls in fns.values():
        for fn in calls:
            fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for calls in fns.values():
        enqueue(calls)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10**6)
    end.record()
    end.synchronize()
    cycles_per_ms = 10**6 / start.elapsed_time(end)
    sleep = int(cycles_per_ms * (2e3 * host_s + 1.0))
    times = {k: [] for k in fns}
    names = list(fns)
    for s in range(samples):
        for k in (names if s % 2 == 0 else names[::-1]):
            torch.cuda._sleep(sleep)
            start.record()
            enqueue(fns[k])
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return {k: float(np.median(v)) for k, v in times.items()}


def cloned(obj):
    """A copy of a tensor, or of a dataclass with every tensor in it (nested
    dataclasses too) cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: cloned(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def bound_ms(nbytes, flops):
    """Least time on the card: bytes over HBM rate vs fp32 operations over
    peak; returns (ms, "bytes" or "operations")."""
    b, f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (b * 1e3, "bytes") if b >= f else (f * 1e3, "operations")


def segsum_bound(m, n, w):
    """Contributions and row pointers read once, out written once."""
    return bound_ms(4 * (m * w + n + 1 + n * w), m * w)


def fused_bound(m, n, w, dh):
    """V, both E copies, the int64 indices and both row_ptr read once, out
    read and written once; dh FMAs per output element, edge and direction."""
    nbytes = 4 * n * w + 2 * 4 * m * dh * dh + 2 * 8 * m + 2 * 4 * (n + 1) \
        + 2 * 4 * n * w
    return bound_ms(nbytes, 2 * m * w * 2 * dh)


def unfused_sequence(outf, Vf, csr):
    """What q_matvec's float32 CSR branch launched before the fused kernel:
    two row gathers, two batched products, two segment-sum kernels and two
    subtractions."""
    m, dh = csr.E_by_j.shape[0], csr.E_by_j.shape[-1]
    r = Vf.shape[1] // dh
    ci = (Vf[csr.src_by_j].reshape(m, r, dh) @ csr.E_by_j).reshape(m, r * dh)
    cj = (Vf[csr.dst_by_i].reshape(m, r, dh)
          @ csr.E_by_i.transpose(-1, -2)).reshape(m, r * dh)
    outf = outf - segsum.segment_sum_csr(ci, csr.plan_j)
    return outf - segsum.segment_sum_csr(cj, csr.plan_i)


def phase_kernel(dev, csr):
    """csr: the slice's float32 CSR plans."""
    rng = np.random.default_rng(0)
    cases = [(1000, 2600, 20), (517, 1399, 9), (100, 5, 12), (4096, 4096, 20),
             (37, 200, 4)]
    for n, m, w in cases:
        dest = np.sort(rng.integers(0, n, m))
        check_segsum(randn(rng, (m, w), dev),
                     segsum.make_segsum_plan(dest, n, device=dev))
    check_segsum(randn(rng, (1000, 8), dev),
                 segsum.make_segsum_plan(np.full(1000, 123), 500, device=dev))
    # the slice's shape and plans
    n, m, w, dh = csr.plan_j.n, csr.plan_j.m, R * (D + 1), D + 1
    C = randn(rng, (m, w), dev)
    seg_slice = max(check_segsum(C, csr.plan_j), check_segsum(C, csr.plan_i))
    seg_err = seg_slice
    lib = torch.segment_reduce(C, "sum", offsets=csr.plan_j.row_ptr, axis=0)
    lib_err = float((lib - segsum.segment_sum_reference(C, csr.plan_j))
                    .abs().max())

    fused_cases = [(1000, 2600, 5, 3, None), (517, 1399, 5, 4, None),
                   (300, 900, 12, 3, None), (500, 1000, 5, 3, 123),
                   (100, 5, 5, 3, None)]
    fused_err = 0.0
    for fn, fm, fr, fdh, hot in fused_cases:
        c = random_csr(rng, fn, fm, fdh, dev, hot=hot)
        fused_err = max(fused_err, check_fused(
            c, randn(rng, (fn, fr * fdh), dev), randn(rng, (fn, fr * fdh), dev)))
    V, out0 = randn(rng, (n, w), dev), randn(rng, (n, w), dev)
    fused_slice = check_fused(csr, V, out0)
    fused_err = max(fused_err, fused_slice)
    print(f"kernel: ok; segsum at {len(cases) + 2} shapes, max_abs_err="
          f"{seg_err:.3e} (segment_reduce vs index_add_ {lib_err:.3e}); "
          f"edge_matvec at {len(fused_cases) + 1} shapes, max_abs_err="
          f"{fused_err:.3e}; identical bits on rerun", flush=True)

    def timed(out, V, csr, C):
        return {
            "edge_matvec": lambda: edge_matvec.edge_matvec(out, V, csr),
            "edge_matvec_reference":
                lambda: edge_matvec.edge_matvec_reference(out, V, csr),
            "unfused_sequence": lambda: unfused_sequence(out, V, csr),
            "segment_sum_csr": lambda: segsum.segment_sum_csr(C, csr.plan_j),
            "segment_reduce": lambda: torch.segment_reduce(
                C, "sum", offsets=csr.plan_j.row_ptr, axis=0),
            "index_add_": lambda: segsum.segment_sum_reference(C, csr.plan_j),
        }

    out = out0.clone()
    sets = [timed(out, V, csr, C)] + [
        timed(*map(cloned, (out, V, csr, C))) for _ in range(COLD_COPIES - 1)]
    ms = device_ms({k: [t[k] for t in sets] for k in sets[0]})
    warm = device_ms({k: [sets[0][k]] for k in sets[0]})
    del sets
    sb, sb_by = segsum_bound(m, n, w)
    fb, fb_by = fused_bound(m, n, w, dh)
    for label, t in (("cold L2", ms), ("warm L2", warm)):
        print(f"kernel: device us/call at n={n} m={m} w={w}, {label} (median "
              f"of CUDA-event means, in turns): edge_matvec "
              f"{t['edge_matvec'] * 1e3:.2f} (bound {fb * 1e3:.2f}, by "
              f"{fb_by}), its plain version "
              f"{t['edge_matvec_reference'] * 1e3:.2f}, the unfused sequence "
              f"{t['unfused_sequence'] * 1e3:.2f}; segment_sum_csr "
              f"{t['segment_sum_csr'] * 1e3:.2f} (bound {sb * 1e3:.2f}, by "
              f"{sb_by}), segment_reduce {t['segment_reduce'] * 1e3:.2f}, "
              f"index_add_ {t['index_add_'] * 1e3:.2f}", flush=True)
    return {
        "segment_sum_csr": {
            "max_abs_err": seg_err, "ms": ms["segment_sum_csr"],
            "plain_ms": ms["index_add_"], "bound_ms": sb, "bound_by": sb_by,
            "library_ms": ms["segment_reduce"],
            "warm_ms": warm["segment_sum_csr"],
            "max_abs_err_by_path": {"slice": seg_slice}},
        "edge_matvec": {
            "max_abs_err": fused_err, "ms": ms["edge_matvec"],
            "plain_ms": ms["edge_matvec_reference"], "bound_ms": fb,
            "bound_by": fb_by, "library_ms": None,
            "replaced_ms": ms["unfused_sequence"],
            "warm_ms": warm["edge_matvec"],
            "max_abs_err_by_path": {"slice": fused_slice}},
    }


def run_slice(edges, n, dev, min_edges=4096):
    """The centralized lifted solve from edges on `dev`; wall times per
    stage, all ending in a synchronize."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t = {}
    sync()
    t0 = time.perf_counter()
    problem = quadratic.from_private_measurements(edges, n=n, d=D, device=dev)
    sync()
    t1 = time.perf_counter()
    T = chordal.chordal_initialization_arrays(
        edges, n=n, cg_dtype=torch.float32, tol=1e-6, maxiter=1000, device=dev)
    X0 = torch.einsum(
        "rd,nde->nre", lifted.fixed_stiefel_variable(D, R, device=dev), T)
    sync()
    t2 = time.perf_counter()
    qd = quadratic.build_quadratic_data(
        problem, torch.zeros((1, R, D + 1), dtype=torch.float64, device=dev),
        r=R, precond="jacobi")
    qd = quadratic.attach_csr_plans(qd, min_edges=min_edges)
    sync()
    t3 = time.perf_counter()
    X, stats = rtr.rtr_solve(qd, X0, **SOLVE)
    sync()
    t4 = time.perf_counter()
    t.update(problem_s=t1 - t0, chordal_s=t2 - t1, build_s=t3 - t2,
             solve_s=t4 - t3, total_s=t4 - t0)
    return X, stats, qd, t


def phase_slice(dev):
    edges, n, _ = datasets.synthesize_city2d(NUM_POSES, seed=0)
    X, stats, qd, _ = run_slice(edges, n, dev)  # warm-up
    if qd.csr is None:
        fail("no CSR plans attached at the slice's size")
    runs = []
    for _ in range(3):
        edge_matvec.LAUNCHES = segsum.LAUNCHES = 0
        X, stats, qd, t = run_slice(edges, n, dev)
        launches = {"edge_matvec": edge_matvec.LAUNCHES,
                    "segment_sum_csr": segsum.LAUNCHES}
        runs.append(t)
    tcg = int(stats.tcg_iters)
    gn = float(stats.gnorm_opt)
    f2 = 2.0 * float(stats.f_opt)
    med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    print(f"slice: city2d n={n} m={edges.m} gather-path edges="
          f"{qd.off_E.shape[0]} | median of 3: total {med['total_s']:.3f} s "
          f"(problem {med['problem_s']:.3f}, chordal {med['chordal_s']:.3f}, "
          f"build+csr {med['build_s']:.3f}, rtr_solve {med['solve_s']:.3f}) | "
          f"rtr_iters={stats.iterations} tcg_iters={tcg} gradnorm={gn:.6e} "
          f"2f={f2:.10f} launches={launches}", flush=True)
    if tuple(X.shape) != (n, R, D + 1) or not bool(torch.isfinite(X).all()):
        fail("solution is not a finite (n, r, d+1) tensor")
    if not gn < SOLVE["gradnorm_tol"]:
        fail(f"gradnorm {gn} not below {SOLVE['gradnorm_tol']}")
    if launches["edge_matvec"] < max(1, tcg):
        fail(f"{launches['edge_matvec']} edge-matvec launches for {tcg} tCG "
             f"iterations")
    rel = abs(f2 - EXPECTED_2F) / EXPECTED_2F
    if not rel <= COST_RTOL:
        fail(f"2f={f2!r} vs expected {EXPECTED_2F!r}: rel {rel:.3e}")
    # a small graph: the same cost on the card as on the CPU
    small, ns, _ = datasets.synthesize_city2d(600, seed=0)
    _, s_gpu, _, _ = run_slice(small, ns, dev, min_edges=0)
    _, s_cpu, _, _ = run_slice(small, ns, torch.device("cpu"), min_edges=0)
    a, b = 2 * float(s_gpu.f_opt), 2 * float(s_cpu.f_opt)
    if not abs(a - b) <= COST_RTOL * abs(b):
        fail(f"city2d(600): card 2f={a!r} vs CPU 2f={b!r}")
    print(f"slice: ok, rel cost err {rel:.3e} vs JAX CPU; city2d(600) card "
          f"2f={a:.10f} CPU 2f={b:.10f}", flush=True)
    return launches


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_auto(dev):
    """rtr_solve_auto with a one-iteration probe: the escalation to the
    banded factor, on the card. Then its two phases one by one, as it runs
    them (build_quadratic_data with attach_csr_plans, then rtr_solve), for
    each phase's build time and counts, and both kernels against their
    plain versions on each phase's float32 CSR plans. Returns the kernels'
    launches in the rtr_solve_auto call and their max abs errors on this
    path's plans."""
    edges, n, _ = datasets.synthesize_grid3d(AUTO_POSES, seed=0)
    problem = quadratic.from_private_measurements(edges, n=n, d=AUTO_D,
                                                  device=dev)
    plan = block_tridiag.make_banded_plan(problem.priv_i.cpu().numpy(),
                                          problem.priv_j.cpu().numpy(), n,
                                          AUTO_D + 1)
    if plan is None:
        fail("auto: the banded plan was refused")
    T = chordal.chordal_initialization_arrays(
        edges, n=n, cg_dtype=torch.float32, tol=1e-6, maxiter=1000, device=dev)
    X0 = torch.einsum(
        "rd,nde->nre", lifted.fixed_stiefel_variable(AUTO_D, R, device=dev), T)
    rtr.rtr_solve_auto(problem, X0, device=dev, **AUTO_SOLVE)  # warm-up
    sync(dev)
    edge_matvec.LAUNCHES = segsum.LAUNCHES = 0
    t0 = time.perf_counter()
    X, stats = rtr.rtr_solve_auto(problem, X0, device=dev, **AUTO_SOLVE)
    sync(dev)
    solve_s = time.perf_counter() - t0
    launches = {"edge_matvec": edge_matvec.LAUNCHES,
                "segment_sum_csr": segsum.LAUNCHES}
    f2, gn, tcg = 2 * float(stats.f_opt), float(stats.gnorm_opt), \
        int(stats.tcg_iters)

    # the same two phases one by one
    zeros_nbr = torch.zeros((1, R, AUTO_D + 1), dtype=torch.float64,
                            device=dev)
    probe = AUTO_SOLVE["probe_iterations"]
    rng = np.random.default_rng(1)
    phases, Y, errs = [], X0, {"edge_matvec": 0.0, "segment_sum_csr": 0.0}
    for precond, iters in (("jacobi", probe),
                           ("banded", AUTO_SOLVE["max_iterations"] - probe)):
        sync(dev)
        t0 = time.perf_counter()
        qd = quadratic.attach_csr_plans(quadratic.build_quadratic_data(
            problem, zeros_nbr, r=R, precond=precond))
        sync(dev)
        build_s = time.perf_counter() - t0
        Y, st = rtr.rtr_solve(
            qd, Y, AUTO_SOLVE["gradnorm_tol"], AUTO_SOLVE["initial_radius"],
            max_iterations=iters, max_inner=AUTO_SOLVE["max_inner"],
            inner_dtype=AUTO_SOLVE["inner_dtype"])
        phases.append((precond, build_s, st, qd))
        if qd.csr is None:
            fail(f"auto: no CSR plans attached in the {precond} phase")
        csr, w = qd.to(torch.float32).csr, R * (AUTO_D + 1)
        errs["edge_matvec"] = max(errs["edge_matvec"], check_fused(
            csr, randn(rng, (n, w), dev), randn(rng, (n, w), dev)))
        C = randn(rng, (csr.plan_j.m, w), dev)
        errs["segment_sum_csr"] = max(errs["segment_sum_csr"],
                                      check_segsum(C, csr.plan_j),
                                      check_segsum(C, csr.plan_i))
    print(f"auto: grid3d n={n} m={edges.m} gather-path edges="
          f"{phases[0][3].off_E.shape[0]} | RCM bandwidth={plan.bandwidth} "
          f"s={plan.s} nb={plan.nb} | " + "; ".join(
              f"{p}: build {b:.4f} s, rtr_iters={int(st.iterations)} "
              f"tcg_iters={int(st.tcg_iters)}" for p, b, st, _ in phases)
          + f" | rtr_solve_auto {solve_s:.3f} s | gradnorm={gn:.6e} "
          f"2f={f2:.10f} launches={launches} | kernels on this path's plans "
          f"(n={n}, m={csr.plan_j.m}, w={w}): max_abs_err {errs}", flush=True)
    if not isinstance(phases[1][3].btf, block_tridiag.BandedFactor):
        fail("auto: no banded factor in the escalation phase")
    p_iters = int(phases[0][2].iterations)
    if not (p_iters == probe and float(phases[0][2].gnorm_opt)
            >= AUTO_SOLVE["gradnorm_tol"]):
        fail("auto: the probe did not stall, so there was no escalation")
    if (int(stats.iterations), tcg) != (
            sum(int(p[2].iterations) for p in phases),
            sum(int(p[2].tcg_iters) for p in phases)):
        fail("auto: the phases one by one disagree with rtr_solve_auto")
    if tuple(X.shape) != (n, R, AUTO_D + 1) or not bool(torch.isfinite(X).all()):
        fail("auto: solution is not a finite (n, r, d+1) tensor")
    if not gn < SOLVE["gradnorm_tol"]:
        fail(f"auto: gradnorm {gn} not below {SOLVE['gradnorm_tol']}")
    if launches["edge_matvec"] < max(1, tcg):
        fail(f"auto: {launches['edge_matvec']} edge-matvec launches for {tcg} "
             f"tCG iterations")
    rel = abs(f2 - AUTO_EXPECTED_2F) / AUTO_EXPECTED_2F
    if not rel <= COST_RTOL:
        fail(f"auto: 2f={f2!r} vs expected {AUTO_EXPECTED_2F!r}: rel {rel:.3e}")
    print(f"auto: ok, rel cost err {rel:.3e} vs JAX CPU", flush=True)
    return launches, errs


def rbcd_team(dev):
    """The rbcd phases' team and initial state, with stage wall times."""
    t = {}
    edges, n, _ = datasets.synthesize_grid3d(RBCD_POSES, seed=1)
    meas = edges.to_measurements()
    sync(dev)
    t0 = time.perf_counter()
    problem, ranges = spmd.build_spmd_problem(meas, n, RBCD_AGENTS, R,
                                              device=dev)
    sync(dev)
    t1 = time.perf_counter()
    T = chordal_initialization(meas, device=dev)
    X0 = torch.einsum("rd,nde->nre",
                      lifted.fixed_stiefel_variable(3, R, device=dev), T)
    state0 = spmd.initial_state(problem, X0, ranges, device=dev)
    sync(dev)
    t.update(problem_s=t1 - t0, chordal_s=time.perf_counter() - t1)
    return problem, state0, n, len(meas), t


def busy_s(events):
    """Seconds of the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def profiled(fn, top=6):
    """One call of fn under torch.profiler: (fn's result, wall s, device
    busy s, device ops, the `top` device ops by total time as (name, ms,
    count)). The profiler slows the host, so the idle share it implies is
    an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in ev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return out, wall, busy_s(ev), len(ev), [
        (k[:60], v[0], v[1]) for k, v in ranked]


def phase_rbcd(dev):
    """The synchronous RBCD engine at full size; returns the kernels'
    launches in the timed runs (the engine attaches no CSR plans)."""
    problem, state0, n, m, t = rbcd_team(dev)
    sync(dev)
    t0 = time.perf_counter()
    run = spmd.make_two_phase_run_fn(problem, RBCD_CFG, device=dev)
    sync(dev)
    t["static_s"] = time.perf_counter() - t0
    splan = run.splan
    if run.precond != "banded" or splan is None:
        fail(f"rbcd: 'auto' chose {run.precond}, not the stacked banded factor")
    print(f"rbcd: grid3d n={n} m={m} agents={RBCD_AGENTS} n_max="
          f"{problem.n_max} r={R} | precond auto -> {run.precond} (stacked "
          f"plan s={splan.s} nb={splan.nb}) | band offsets "
          f"{problem.band_offsets}, {problem.num_band} banded edges per agent",
          flush=True)
    run(state0, 2000, RBCD_TOL)  # warm-up
    runs = []
    edge_matvec.LAUNCHES = segsum.LAUNCHES = 0
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        state, metrics, rounds = run(state0, 2000, RBCD_TOL)
        sync(dev)
        runs.append((time.perf_counter() - t0, rounds, run.switch_round,
                     float(metrics.gradnorm), float(metrics.cost)))
    launches = {"edge_matvec": edge_matvec.LAUNCHES,
                "segment_sum_csr": segsum.LAUNCHES}
    rounds_s = [r[0] for r in runs]
    per_round = [1e3 * r[0] / r[1] for r in runs]
    print(f"rbcd: stages problem {t['problem_s']:.3f} s, chordal "
          f"{t['chordal_s']:.3f} s, static data (Q blocks, factors and their "
          f"float32 copy, shared by both phases) {t['static_s']:.3f} s | 3 runs to gradnorm < {RBCD_TOL}: "
          f"rounds {[r[1] for r in runs]}, switch at {[r[2] for r in runs]}, "
          f"wall {[round(x, 4) for x in rounds_s]} s (median "
          f"{np.median(rounds_s):.4f}), ms/round {[round(x, 3) for x in per_round]}"
          f" (median {np.median(per_round):.3f}) | gradnorm "
          f"{[r[3] for r in runs]} cost {[r[4] for r in runs]} | JAX CPU: "
          f"{RBCD_JAX_ROUNDS} rounds, cost {RBCD_EXPECTED_COST} | launches "
          f"{launches}", flush=True)
    if tuple(state.X.shape) != (RBCD_AGENTS, problem.n_max, R, 4) or \
            not bool(torch.isfinite(state.X).all()):
        fail("rbcd: state is not a finite (N, n_max, r, d+1) tensor")
    for _, _, _, gn, cost in runs:
        rel = abs(cost - RBCD_EXPECTED_COST) / RBCD_EXPECTED_COST
        if not (gn < RBCD_TOL and rel <= RBCD_COST_RTOL):
            fail(f"rbcd: gradnorm {gn} / cost {cost!r} (rel {rel:.3e} vs "
                 f"{RBCD_EXPECTED_COST})")
    # where a run's time goes: one more run under the profiler
    (_, _, rounds), wall, busy, ops, top = profiled(
        lambda: run(state0, 2000, RBCD_TOL))
    print(f"rbcd: profiled run: {rounds} rounds, wall {wall:.3f} s, device "
          f"busy {busy:.3f} s (idle share {1 - busy / wall:.3f}), {ops} "
          f"device ops ({ops / rounds:.0f} per round) | top device ops, ms "
          f"(count): " + "; ".join(f"{k} {ms:.1f} ({c})" for k, ms, c in top),
          flush=True)
    # the Nesterov projections at the team's shape, device time per call
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.standard_normal((RBCD_POSES, R, 4)), device=dev)
    M = state.X.reshape(-1, R, 4) + 0.01 * M[: RBCD_AGENTS * problem.n_max]
    proj = device_ms({"project_lifted": [lambda: lifted.project_lifted(M)],
                      "project_lifted_ns_mixed":
                          [lambda: lifted.project_lifted_ns_mixed(M)]},
                     reps=5, samples=5)
    err = float((lifted.project_lifted(M)
                 - lifted.project_lifted_ns_mixed(M)).abs().max())
    print(f"rbcd: ok | device ms/call at {tuple(M.shape)} float64: "
          f"project_lifted (SVD) {proj['project_lifted']:.3f}, "
          f"project_lifted_ns_mixed {proj['project_lifted_ns_mixed']:.3f} "
          f"(max abs diff {err:.2e})", flush=True)
    return launches, problem, state0


def phase_rbcd_f64(dev, problem, state0):
    """20 float64 rounds in modes 'all' and 'greedy' against the JAX
    package's."""
    for mode, (cost_ref, gn_ref) in F64_EXPECTED.items():
        cfg = dataclasses.replace(RBCD_CFG, rtr_inner_dtype=None, mode=mode)
        run = spmd.make_run_fn(problem, cfg, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        _, m, rounds = run(state0, 20, 0.0)
        sync(dev)
        wall = time.perf_counter() - t0
        cost, gn = float(m.cost), float(m.gradnorm)
        rc, rg = abs(cost - cost_ref) / cost_ref, abs(gn - gn_ref) / gn_ref
        print(f"rbcd-f64: {mode}: {rounds} rounds in {wall:.3f} s | cost "
              f"{cost:.12f} (rel {rc:.2e}) gradnorm {gn:.12e} (rel {rg:.2e}) "
              f"vs JAX CPU", flush=True)
        if rounds != 20 or not (rc <= F64_RTOL and rg <= F64_RTOL):
            fail(f"rbcd-f64: {mode} off the JAX package's values")
    print("rbcd-f64: ok", flush=True)


def slice_plans(dev):
    """The slice's float32 CSR plans, as the tCG's matvecs see them."""
    edges, n, _ = datasets.synthesize_city2d(NUM_POSES, seed=0)
    problem = quadratic.from_private_measurements(edges, n=n, d=D, device=dev)
    qd = quadratic.attach_csr_plans(quadratic.build_q_data(problem, R))
    if qd.csr is None:
        fail("no CSR plans attached at the slice's size")
    return qd.to(torch.float32).csr


def main():
    dev, smi_line = phase_device()
    phase_build()
    k = phase_kernel(dev, slice_plans(dev))
    paths = {"slice": phase_slice(dev)}
    paths["auto"], auto_errs = phase_auto(dev)
    for name, err in auto_errs.items():
        k[name]["max_abs_err"] = max(k[name]["max_abs_err"], err)
        k[name]["max_abs_err_by_path"]["auto"] = err
    paths["rbcd"], problem, state0 = phase_rbcd(dev)
    phase_rbcd_f64(dev, problem, state0)
    launches = paths["slice"]
    print(smi_line, flush=True)
    sources = {
        "segment_sum_csr": ("dpgo_tpu_torch/csrc/segsum.cu", {}),
        "edge_matvec": ("dpgo_tpu_torch/csrc/edge_matvec.cu",
                        {"replaces_also": "dpgo_tpu/quadratic.py:597-612"}),
    }
    kernels = []
    for name, (source, extra) in sources.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "dpgo_tpu/ops/pallas_segsum.py:213",
            "launches": launches[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            **k[name],
            "bound_us": k[name]["bound_ms"] * 1e3, **extra})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
