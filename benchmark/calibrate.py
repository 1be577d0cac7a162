#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from; not part of a run.

    python3 benchmark/calibrate.py --workload <name> [--instances 16] \
        [--control]

In one process on the card: one solve of each of the first `instances`
instances of the cell's mix (the first `pool` of them are the pool a run
walks through; the rest are further draws of the same kind), each judged
by the plain reference as a run judges it; on a warm mix after one solve
of the previous map. With --control the program runs with its iterate and
trust-region control in float32, the nearest precision below the float64
that the configuration states, the path a later change might be tempted
by. Prints one JSON line per instance and then the largest and smallest
reading of each compared number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402


def control_config(config: dict) -> dict:
    """The configuration with its float64 stages in float32."""
    prec = {k: "float32" if v == "float64" else v
            for k, v in config["precision"].items()}
    return dict(config, precision=prec)


def readings(bench, workload, instances, control, device, config=None,
             mix=None):
    """One dict per instance: its solve's seconds, counters and the
    reference's readings."""
    from benchmark.harness import check, traffic, tracing

    cell, config, mix = run.cell_files(bench, workload, config, mix)
    if control:
        config = control_config(config)
    engine = run.load("engines", config["engine"]).Engine(config, device)
    world = traffic.world(mix)
    n, d = mix["num_poses"], world.d
    X_start = None
    if mix["start"] == "warm":
        X_start, _ = engine.answer(engine.solve(engine.prepare(
            traffic.previous_map(world, mix), n, d), tracing.OFF))
    out = []
    for k in range(instances):
        edges = traffic.instance(world, mix, k)
        inp = engine.prepare(edges, n, d)
        tracing.sync(device)
        t0 = time.perf_counter()
        res = engine.solve(inp, tracing.OFF, X_start)
        tracing.sync(device)
        sec = time.perf_counter() - t0
        X, counters = engine.answer(res)
        r = check.judge_solve(edges, X, counters, config["limits"])
        out.append({"instance": k, "control": control, "seconds": sec,
                    "counters": check.summary([{"counters": counters}]),
                    "readings": r})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--instances", type=int, default=16)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = run.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    rows = readings(bench, args.workload, args.instances, args.control,
                    torch.device("cuda", 0))
    for row in rows:
        print(json.dumps(row), flush=True)
    names = [k for k in rows[0]["readings"] if k != "ok"]
    print(json.dumps({
        "workload": args.workload, "control": args.control,
        "max": {k: max(r["readings"][k] for r in rows) for k in names},
        "min": {k: min(r["readings"][k] for r in rows) for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
