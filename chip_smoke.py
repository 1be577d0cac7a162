#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dpgo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each, in order; any failure exits non-zero before the last
line:
  1. device: requires CUDA; prints the card and nvidia-smi's name and power
     limit, and turns TF32 off.
  2. build: compiles the CUDA kernels from dpgo_tpu_torch/csrc with nvcc.
  3. kernel: the CSR segment-sum kernel against its plain version (index_add_)
     at the shapes of tests/test_pallas_segsum.py, a hotspot/empty-rows case
     and the slice's own plans (n = 100,000 rows, m = 92,595 edges, w = 15);
     two runs must give identical bits. Times both at the slice's shape.
  4. slice: the centralized lifted solve on synthesize_city2d(100000, seed=0),
     d = 2, r = 5 — chordal init (float32 CG, tol 1e-6), lift, block-Jacobi,
     CSR plans, RTR with float32 tCG and float64 control to gradnorm < 1e-2 —
     once to warm up and three times timed. The last run must launch the
     kernel at least twice per tCG iteration and land on the JAX package's
     cost within 1e-6 relative; a small graph must give the same cost on the
     card as on the CPU.
Then a JSON line with the kernels' numbers and, last, the JSON result line.

Imports nothing of JAX or dpgo_tpu.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dpgo_tpu_torch import datasets, quadratic
from dpgo_tpu_torch.ops import _build, lifted, segsum
from dpgo_tpu_torch.solvers import chordal, rtr

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
SOLVE = dict(gradnorm_tol=1e-2, initial_radius=100.0, max_iterations=100,
             max_inner=200, inner_dtype=torch.float32)


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


def _check_kernel(C, plan):
    """Kernel vs plain on one input; returns the max abs error."""
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


def _median_ms(fn, reps=50, samples=21):
    """Median over samples of the mean per-call time of `reps` calls,
    measured with CUDA events after a warm-up."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def phase_kernel(dev, csr):
    rng = np.random.default_rng(0)
    cases = [(1000, 2600, 20), (517, 1399, 9), (100, 5, 12), (4096, 4096, 20),
             (37, 200, 4)]
    for n, m, w in cases:
        dest = np.sort(rng.integers(0, n, m))
        C = torch.as_tensor(rng.standard_normal((m, w)), dtype=torch.float32,
                            device=dev)
        _check_kernel(C, segsum.make_segsum_plan(dest, n, device=dev))
    C = torch.as_tensor(rng.standard_normal((1000, 8)), dtype=torch.float32,
                        device=dev)
    _check_kernel(C, segsum.make_segsum_plan(np.full(1000, 123), 500,
                                             device=dev))
    # the slice's shape and plans
    m = csr.plan_j.m
    w = R * (D + 1)
    C = torch.as_tensor(rng.standard_normal((m, w)), dtype=torch.float32,
                        device=dev)
    err = max(_check_kernel(C, csr.plan_j), _check_kernel(C, csr.plan_i))
    ms = _median_ms(lambda: segsum.segment_sum_csr(C, csr.plan_j))
    plain_ms = _median_ms(lambda: segsum.segment_sum_reference(C, csr.plan_j))
    print(f"kernel: ok at {len(cases) + 1} test shapes and the slice's "
          f"(n={csr.plan_j.n}, m={m}, w={w}); max_abs_err={err:.3e}; "
          f"segsum {ms * 1e3:.2f} us vs index_add_ {plain_ms * 1e3:.2f} us "
          f"(median of CUDA-event means)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
        segsum.LAUNCHES = 0
        X, stats, qd, t = run_slice(edges, n, dev)
        launches = segsum.LAUNCHES
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
          f"2f={f2:.10f} segsum_launches={launches}", flush=True)
    if tuple(X.shape) != (n, R, D + 1) or not bool(torch.isfinite(X).all()):
        fail("solution is not a finite (n, r, d+1) tensor")
    if not gn < SOLVE["gradnorm_tol"]:
        fail(f"gradnorm {gn} not below {SOLVE['gradnorm_tol']}")
    if launches < max(1, 2 * tcg):
        fail(f"{launches} kernel launches for {tcg} tCG iterations")
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
    return launches, qd.csr


def main():
    dev, smi_line = phase_device()
    phase_build()
    # the slice's CSR plans, for the kernel phase at the real shape
    edges, n, _ = datasets.synthesize_city2d(NUM_POSES, seed=0)
    problem = quadratic.from_private_measurements(edges, n=n, d=D, device=dev)
    qd = quadratic.attach_csr_plans(quadratic.build_q_data(problem, R))
    if qd.csr is None:
        fail("no CSR plans attached at the slice's size")
    k = phase_kernel(dev, qd.csr)
    launches, _ = phase_slice(dev)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": [{
        "name": "segment_sum_csr",
        "route": "cuda",
        "source": "dpgo_tpu_torch/csrc/segsum.cu",
        "replaces": "dpgo_tpu/ops/pallas_segsum.py:213",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
