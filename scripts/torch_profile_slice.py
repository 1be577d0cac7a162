#!/usr/bin/env python3
"""Where the time of the port's centralized slice goes, on one CUDA card.

    python3 scripts/torch_profile_slice.py [summary.json]

Runs chip_smoke.run_slice on synthesize_city2d(100000, seed=0) once to warm
up, then once under torch.profiler, and prints:
  * wall time per stage (host clock, each stage ends in a synchronize);
  * device busy time (union of kernel and memory-op intervals) and the
    device's idle share of the profiled wall time;
  * the device-side launch count and the top device ops by total time;
  * the segment-sum kernel's and index_add_'s device time per call at the
    slice's shape.
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
from dpgo_tpu_torch.ops import segsum  # noqa: E402


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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

    rng = np.random.default_rng(0)
    C = torch.as_tensor(rng.standard_normal((qd.csr.plan_j.m, 15)),
                        dtype=torch.float32, device=dev)
    k_us, k_n = _device_us_per_call(lambda: segsum.segment_sum_csr(C, qd.csr.plan_j))
    p_us, p_n = _device_us_per_call(
        lambda: segsum.segment_sum_reference(C, qd.csr.plan_j))

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
        "segsum_kernel_device_us_per_call": k_us,
        "segsum_kernel_device_ops_per_call": k_n,
        "index_add_plain_device_us_per_call": p_us,
        "index_add_plain_device_ops_per_call": p_n,
    }
    print(json.dumps(summary, indent=1))
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
