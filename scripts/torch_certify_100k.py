#!/usr/bin/env python3
"""Does the plain float64 RBCD engine certify the 100,000-pose city on a
CUDA card, where float64 is native, and how does it compare with the
anchored delta engine (float32 problem and deltas, float64 host anchor)?

    python3 scripts/torch_certify_100k.py [out.json]

On chip_smoke.py's certified team (synthesize_city2d(100000, seed=0) in 10
agents at r = 5, from the float32-CG chordal init lifted in float64) it
runs, one after the other on the card:
  * the delta engine: run_delta_certified under scale_bench.py's city
    schedule (tCG cap 3, restart_scheme 'exact') to tol 0.9e-2, after a
    1-round warm-up;
  * the plain engine on the float64 problem with the same schedule
    (restart_scheme aside: the plain engine compares costs), in calls of 25
    rounds until the host float64 gradnorm is below 1e-2 or 1,000 rounds,
    after a 1-round warm-up.
Each is certified by delta.host_certify (numpy float64). Prints the card's
name and power limit and one JSON line, also written to out.json when a
path is given.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from dpgo_tpu_torch import datasets  # noqa: E402
from dpgo_tpu_torch.ops import lifted  # noqa: E402
from dpgo_tpu_torch.parallel import delta, spmd  # noqa: E402
from dpgo_tpu_torch.solvers import chordal  # noqa: E402

N_POSES, AGENTS, R, D, TOL = 100_000, 10, 5, 2, 1e-2
CHUNK, MAX_ROUNDS = 25, 1000
SCHEDULE = dict(
    mode="all", acceleration=True, rtr_iterations=1, adaptive_restart=True,
    restart_interval=10**6, nesterov_n=5, rtr_tcg_iterations=3,
    rtr_residual_control=True, rtr_gradnorm_tol=TOL / (2 * np.sqrt(AGENTS)))


def sync():
    torch.cuda.synchronize()


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else None
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)

    edges, n, _ = datasets.synthesize_city2d(N_POSES, seed=0)
    meas = edges.to_measurements()
    T = chordal.chordal_initialization_arrays(
        edges, n=n, cg_dtype=torch.float32, tol=1e-6, maxiter=1000,
        device=dev)
    X0 = torch.einsum("rd,nde->nre",
                      lifted.fixed_stiefel_variable(D, R, device=dev), T)

    # the delta engine
    p32, ranges = spmd.build_spmd_problem(meas, n, AGENTS, R,
                                          dtype=torch.float32, device=dev)
    p64, _ = spmd.build_spmd_problem(meas, n, AGENTS, R, dtype=torch.float64,
                                     device=dev)
    state0 = spmd.initial_state(p64, X0, ranges, device=dev)
    Xs = state0.X.cpu().numpy()
    cfg_d = spmd.SPMDConfig(restart_scheme="exact", **SCHEDULE)
    kw = dict(tol=0.9 * TOL, chunk=CHUNK, reanchor_every=25, device=dev)
    delta.run_delta_certified(p32, Xs, cfg_d, max_rounds=1, **kw)
    sync()
    t0 = time.perf_counter()
    Xd, info = delta.run_delta_certified(p32, Xs, cfg_d, max_rounds=3000, **kw)
    sync()
    delta_s = time.perf_counter() - t0
    cost_d, gn_d = delta.host_certify(p64, Xd)
    print(f"delta engine: {info['rounds']} rounds, {delta_s:.3f} s, host "
          f"gradnorm {gn_d:.6e}, host cost {cost_d:.10f}", flush=True)

    # the plain float64 engine, same schedule
    cfg = spmd.SPMDConfig(**SCHEDULE)
    run = spmd.make_run_fn(p64, cfg, device=dev)
    run(state0, 1, 0.0)
    trace, total, gn, plain_s = [], 0, float("inf"), 0.0
    state = state0
    while total < MAX_ROUNDS and gn >= TOL:
        sync()
        t0 = time.perf_counter()
        state, m, rounds = run(state, CHUNK, 0.0)
        sync()
        plain_s += time.perf_counter() - t0  # the host checks excluded
        total += rounds
        cost, gn = delta.host_certify(p64, state.X.cpu().numpy())
        trace.append({"rounds": total, "device_gradnorm": float(m.gradnorm),
                      "host_gradnorm": gn, "host_cost": cost})
        print(f"  float64 engine round {total}: host gradnorm {gn:.6e}",
              flush=True)
    result = {
        "card": smi, "n": n, "agents": AGENTS, "r": R,
        "precond": run.precond,
        "delta": {"rounds": info["rounds"], "seconds": delta_s,
                  "ms_per_round": 1e3 * delta_s / info["rounds"],
                  "host_gradnorm": gn_d, "host_cost_2f": cost_d},
        "float64": {"rounds": total, "seconds": plain_s,
                    "ms_per_round": 1e3 * plain_s / max(total, 1),
                    "host_gradnorm": gn, "host_cost_2f": trace[-1]["host_cost"],
                    "certified": gn < TOL, "trace": trace},
    }
    print(json.dumps(result), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
