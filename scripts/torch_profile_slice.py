#!/usr/bin/env python3
"""Where the time of the port's centralized slice goes, on one CUDA card.

    python3 scripts/torch_profile_slice.py [summary.json]

Runs chip_smoke.run_slice on synthesize_city2d(100000, seed=0) once to warm
up, then once under torch.profiler, and prints:
  * wall time per stage (host clock, each stage ends in a synchronize);
  * device busy time (union of kernel and memory-op intervals) and the
    device's idle share of the profiled wall time;
  * the device-side launch count and the top device ops by total time;
  * the top ATen ops by the device time of the kernels they launch, split
    by input shapes, which says which call sites the kernels belong to;
  * the fused edge-matvec kernel's device time per call inside the solve;
  * at the slice's shape, outside the solve: the device time per call of
    the fused kernel, its plain version and the unfused sequence it replaces,
    and of the segment-sum kernel, torch.segment_reduce and index_add_.
With a path argument the summary is also written there as JSON.
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from dpgo_tpu_torch import datasets  # noqa: E402
from dpgo_tpu_torch.ops import edge_matvec, segsum  # noqa: E402


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(events):
    """Length of the union of the device intervals."""
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
    return busy


def _device_us_per_call(fn, calls=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = _device_events(prof)
    return sum(e.time_range.elapsed_us() for e in ev) / calls, len(ev) / calls


def main():
    dev, smi_line = chip_smoke.phase_device()  # exits without a card
    edges, n, _ = datasets.synthesize_city2d(chip_smoke.NUM_POSES, seed=0)
    _, _, qd, _ = chip_smoke.run_slice(edges, n, dev)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        _, stats, qd, stages = chip_smoke.run_slice(edges, n, dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = _device_events(prof)
    busy = _busy_us(ev)
    by_name = {}
    for e in ev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    aten = [a for a in prof.key_averages(group_by_input_shape=True)
            if a.key.startswith("aten::") and a.self_device_time_total > 0]
    aten.sort(key=lambda a: -a.self_device_time_total)

    fused = [v for name, v in by_name.items() if "edge_matvec" in name]
    fused_ms = sum(v[0] for v in fused) / 1e3
    fused_calls = sum(v[1] for v in fused)

    csr = chip_smoke.slice_plans(dev)
    rng = np.random.default_rng(0)
    w = chip_smoke.R * (chip_smoke.D + 1)
    C = chip_smoke.randn(rng, (csr.plan_j.m, w), dev)
    V = chip_smoke.randn(rng, (n, w), dev)
    out = chip_smoke.randn(rng, (n, w), dev)
    per_call = {
        "edge_matvec": lambda: edge_matvec.edge_matvec(out, V, csr),
        "edge_matvec_reference":
            lambda: edge_matvec.edge_matvec_reference(out, V, csr),
        "unfused_sequence": lambda: chip_smoke.unfused_sequence(out, V, csr),
        "segment_sum_csr": lambda: segsum.segment_sum_csr(C, csr.plan_j),
        "segment_reduce": lambda: torch.segment_reduce(
            C, "sum", offsets=csr.plan_j.row_ptr, axis=0),
        "index_add_": lambda: segsum.segment_sum_reference(C, csr.plan_j),
    }
    outside = {}
    for name, fn in per_call.items():
        us, ops = _device_us_per_call(fn)
        outside[name] = {"device_us_per_call": us, "device_ops_per_call": ops}

    summary = {
        "device": smi_line,
        "stages_s": stages,
        "rtr_iters": stats.iterations,
        "tcg_iters": int(stats.tcg_iters),
        "profiled_wall_s": wall_us / 1e6,
        "device_busy_s": busy / 1e6,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_ops": len(ev),
        "top_device_ops": [
            {"name": k[:90], "total_ms": v[0] / 1e3, "count": v[1]}
            for k, v in top
        ],
        "top_aten_ops_by_shape": [
            {"op": a.key, "shapes": str(a.input_shapes)[:120], "count": a.count,
             "device_ms": a.self_device_time_total / 1e3}
            for a in aten[:20]
        ],
        "edge_matvec_in_solve": {
            "calls": fused_calls, "total_ms": fused_ms,
            "us_per_call": 1e3 * fused_ms / max(fused_calls, 1)},
        "at_slice_shape": outside,
    }
    print(json.dumps(summary, indent=1))
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
