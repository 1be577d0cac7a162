#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
"workloads"; its configuration is benchmark/configs/<config>.json, its
traffic mix benchmark/traffic/<traffic>.json, the configuration's engine
benchmark/engines/<engine>.py and each per-layer metric's reader
benchmark/metrics/<metric>.py, all found by name.

A run: set-up (the world, the warm mix's previous map, one warm-up solve
of this cell's shapes, which builds the kernels' library where it is not
built), then a closed loop of whole solves through the mix's pool of
instances until --seconds have passed, then the plain reference judges
every solve's answer. The last line of standard output is the result's JSON; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the kernels' build directories, fixed inside the checkout: the package
# builds its CUDA library under build/dpgo_tpu_torch/ (ops/_build.py)
TRITON_CACHE_DIR = os.path.join(ROOT, "build", "triton")
# the profiler records whole solves of a traced window until this much
# wall time has passed; the spans cover every solve
PROFILE_S = 5.0


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def solve_metrics(bench: dict, workload: str) -> list:
    """The end-to-end metrics that list this cell: each reads the window's
    mean solve time (setup_s, which lists no cells, is every cell's)."""
    return [m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", ())]


def per_layer_names(bench: dict, workload: str, reports) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    return [m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reports)]


def cell_files(bench: dict, workload: str, config: dict = None,
               mix: dict = None):
    """(cell, configuration, traffic mix); config and mix replace the
    cell's files (the tests' small sizes). Turns TF32 off: the
    configurations state full float32."""
    import torch

    cell = cell_of(bench, workload)
    config = config or read_json(os.path.join(HERE, "configs",
                                              cell["config"] + ".json"))
    mix = mix or read_json(os.path.join(HERE, "traffic",
                                        cell["traffic"] + ".json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cell, config, mix


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, config: dict = None, mix: dict = None,
             t_start: float = None) -> dict:
    """One run of the cell; returns the result (its "check" key last).
    config and mix: as in cell_files."""
    import torch
    from torch.autograd import DeviceType

    from benchmark.harness import check, traffic, tracing

    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, mix = cell_files(bench, workload, config, mix)
    engine = load("engines", config["engine"]).Engine(config, device)
    world = traffic.world(mix)
    n, d = mix["num_poses"], world.d

    def solve(edges, spans=tracing.OFF, X_start=None):
        return engine.solve(engine.prepare(edges, n, d), spans, X_start)

    # set-up: the previous map (warm mixes), then one warm-up solve
    X_start = None
    if mix["start"] == "warm":
        X_start, _ = engine.answer(solve(traffic.previous_map(world, mix)))
    engine.answer(solve(traffic.warmup(world, mix, seed), X_start=X_start))
    tracing.sync(device)
    setup_s = time.perf_counter() - t_start

    spans = tracing.Spans(device, trace)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    solves, answers = [], []
    profiled_s = 0.0
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < seconds:
        k = traffic.pool_index(mix, seed, len(solves))
        inp = engine.prepare(traffic.instance(world, mix, k), n, d)
        profiling = prof is not None and profiled_s < PROFILE_S
        tracing.sync(device)
        t0 = time.perf_counter()
        spans.begin_solve()
        with spans.span("solve"):
            out = engine.solve(inp, spans, X_start)
        tracing.sync(device)
        sec = time.perf_counter() - t0
        X, counters = engine.answer(out)
        del out
        answers.append(X.detach().to("cpu"))
        solves.append({"seconds": sec, "spans": dict(spans.current),
                       "counters": counters, "profiled": profiling,
                       "instance": k})
        if profiling:
            profiled_s += sec
            if profiled_s >= PROFILE_S or time.perf_counter() - t_window >= seconds:
                prof.stop()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    del X, X_start, engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference judges every solve of the window
    readings = [check.judge_solve(
        traffic.instance(world, mix, s["instance"]), X.to(device),
        s["counters"], config["limits"]) for s, X in zip(solves, answers)]
    failed = sum(not r["ok"] for r in readings)
    compared = check.worst(readings, config["limits"])

    result = {"correct": failed == 0 and bool(solves),
              "attempted": len(solves), "failed": failed}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": memory_peak}
    reports = solve_metrics(bench, workload) + ["setup_s"]
    if not trace:
        mean = sum(s["seconds"] for s in solves) / max(1, len(solves))
        result["metrics"] = {name: {"value": mean, "unit": "s"}
                             for name in reports}
        result["metrics"]["setup_s"]["value"] = setup_s
    else:
        host = tracing.host_spans(prof, DeviceType.CPU)
        # the profiler mirrors each benchmark range on the device's
        # timeline; those are not device work
        dev_events = tracing.within(
            [e for e in tracing.device_events(prof, DeviceType.CUDA)
             if not e[0].startswith("bench/")],
            [(s, e) for name, s, e in host if name == "solve"])
        tr = tracing.Trace(
            engine=config["engine"], solves=solves, device_events=dev_events,
            host_spans=host, window_s=profiled_s)
        result["metrics"] = {}
        for name in per_layer_names(bench, workload, reports):
            metric = load("metrics", name)
            value = metric.read(tr)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": metric.UNIT}
        dev_info["busy_s"] = tracing.busy_s([e[1:] for e in dev_events])
        dev_info["window_s"] = profiled_s
        if dev_events:
            result["breakdown"] = tracing.breakdown(tr)
    result["device"] = dev_info
    result["solves"] = {"seconds": [s["seconds"] for s in solves],
                        "instance": [s["instance"] for s in solves],
                        "setup_s": setup_s,
                        "counters": check.summary(solves)}
    result["check"] = compared
    return result


def power_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cell_of(bench, args.workload)
    os.environ["TRITON_CACHE_DIR"] = TRITON_CACHE_DIR
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s), this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      t_start=T_START)
    print(f"card: {power_limit()}", flush=True)
    print("solves: " + json.dumps(result.pop("solves")), flush=True)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "dpgo_tpu"))
    if leaked:
        print(f"no result: the run imported {leaked[:5]}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
