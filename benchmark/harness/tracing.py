"""What a traced run records, and the reductions the metric readers share.

Spans are the benchmark's own, placed around its calls into the program's
layers. Untraced runs record none and add no synchronize. In a traced run
each span ends in a synchronize, so its host-clock length holds the device
work it queued, and it is also a torch.profiler range ("bench/<name>"),
which labels the device's idle gaps.

busy_s and device_events are copied from chip_smoke.py: the union of the
device intervals, and the device events read from the profiler's raw
results (prof.events() builds a tree of every host and device event first,
minutes for the 10^6 events of a long run).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Per-solve span seconds; a no-op unless `on`."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on = device, on
        self.current: Dict[str, float] = {}

    def begin_solve(self) -> None:
        self.current = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function("bench/" + name):
            t0 = time.perf_counter()
            yield
            sync(self.device)
        self.current[name] = self.current.get(name, 0.0) + (
            time.perf_counter() - t0)


OFF = Spans(torch.device("cpu"), False)


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read. solves: one dict per solve of the
    window, {"seconds", "spans": {name: s}, "counters": {...}, "profiled"};
    device_events and host_spans: (name, start us, end us) of the profiled
    solves, whose summed host-clock length is window_s."""

    engine: str
    solves: List[dict]
    device_events: List[Tuple[str, float, float]]
    host_spans: List[Tuple[str, float, float]]
    window_s: float

    def timed(self) -> List[dict]:
        """The solves that span times are read from: those the profiler did
        not slow, where the window has any."""
        return [s for s in self.solves if not s["profiled"]] or self.solves

    def span_mean(self, engine: str, name: str) -> Optional[float]:
        """Seconds of span `name` per solve, over the solves that have it."""
        vals = [s["spans"][name] for s in self.timed() if name in s["spans"]]
        if self.engine != engine or not vals:
            return None
        return sum(vals) / len(vals)

    def counter_mean(self, engine: str, name: str) -> Optional[float]:
        vals = [s["counters"][name] for s in self.solves
                if s["counters"].get(name) is not None]
        if self.engine != engine or not vals:
            return None
        return sum(vals) / len(vals)

    def idle_percent(self, engine: str) -> Optional[float]:
        if self.engine != engine or not self.device_events or self.window_s <= 0:
            return None
        busy = busy_s([e[1:] for e in self.device_events])
        return 100.0 * (1.0 - busy / self.window_s)


def busy_s(spans) -> float:
    """Seconds of the union of the (start us, end us) intervals."""
    return sum(e - s for s, e in merged(spans)) / 1e6


def merged(spans) -> List[Tuple[float, float]]:
    """The union of the (start, end) intervals, as disjoint sorted ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def device_events(prof, device_type):
    """(name, start us, end us) of each event on `device_type`."""
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == device_type]


def host_spans(prof, device_type):
    """The benchmark's own ranges among the profiler's host events."""
    return [(name[len("bench/"):], s, e)
            for name, s, e in device_events(prof, device_type)
            if name.startswith("bench/")]


def within(events, intervals):
    """The events that start inside one of the (start, end) intervals: the
    device work of the timed solves, without the benchmark's own copies
    between them."""
    iv = merged(intervals)
    starts = [s for s, _ in iv]
    out = []
    for ev in events:
        k = bisect.bisect_right(starts, ev[1]) - 1
        if k >= 0 and ev[1] <= iv[k][1]:
            out.append(ev)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device inside the solves, each named by the innermost benchmark
    span open on the host at the gap's middle."""
    by_name: Dict[str, float] = {}
    for name, s, e in trace.device_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    solves = merged([(s, e) for name, s, e in trace.host_spans
                     if name == "solve"])
    starts = [s for s, _ in solves]

    def solve_of(t):
        return bisect.bisect_right(starts, t) - 1

    busy = merged([e[1:] for e in trace.device_events])
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(busy, busy[1:])
                   if solve_of(a[1]) == solve_of(b[0])), reverse=True)[:top]

    def label(t):
        open_ = [(e - s, name) for name, s, e in trace.host_spans if s <= t <= e]
        return min(open_)[1]

    return {"device_ops": [[name[:120], sec] for name, sec in ops],
            "idle_gaps": [[label(mid), us / 1e6] for us, mid in gaps]}
