"""The fused edge kernel's share of its roofline in the profiled
centralized solves, in %: the least time the card could take for the
kernel's launches at each solve's shapes (harness/roofline.py: each input
byte read once, each output byte written once, at the H100's published
peaks) over the device time of its events (ops/edge_matvec.py ->
csrc/edge_matvec.cu). Nothing to read where the kernel did not launch."""

from benchmark.harness import roofline

UNIT = "%"


def read(trace):
    if trace.engine != "central":
        return None
    kernel_s = sum(e - s for name, s, e in trace.device_events
                   if "edge_matvec" in name) / 1e6
    bound = sum(c["edge_matvec_launches"] * roofline.edge_matvec_bound(
        c["gather_edges"], c["n"], c["w"], c["dh"])[0]
        for c in (s["counters"] for s in trace.solves if s["profiled"]))
    if kernel_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / kernel_s
