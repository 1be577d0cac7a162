"""The per-layer readers, on recorded fake traces, and BENCHMARK.json's
metrics against the cells and files that report them."""

import os

import pytest

from benchmark import run
from benchmark.harness import roofline, tracing

KERNEL = "edge_matvec_f32_kernel(float const*, long const*, float const*)"


def central_trace():
    counters = {"tcg_iters": 410, "edge_matvec_launches": 410,
                "gather_edges": 92595, "n": 100000, "w": 15, "dh": 3}
    solves = [
        {"seconds": 2.0, "profiled": True, "counters": dict(counters),
         "spans": {"solve": 2.0, "plan": 0.2, "chordal": 1.0, "rtr": 0.8}},
        {"seconds": 2.2, "profiled": False,
         "counters": dict(counters, tcg_iters=420),
         "spans": {"solve": 2.2, "plan": 0.3, "chordal": 1.1, "rtr": 0.8}},
    ]
    # 410 kernel calls of 20 us, a 1.0 s copy, a last 10 us kernel
    events = [(KERNEL, 1000.0 + 100 * k, 1020.0 + 100 * k) for k in range(410)]
    events += [("Memcpy DtoD", 100000.0, 1100000.0),
               ("void last", 1990000.0, 1990010.0)]
    host = [("solve", 0.0, 2.0e6), ("chordal", 0.0, 1.0e6),
            ("rtr", 1.2e6, 2.0e6)]
    return tracing.Trace("central", solves, events, host, window_s=2.0)


def team_trace():
    solves = [{"seconds": 4.0, "profiled": True,
               "counters": {"rounds": 130, "switch_round": 100},
               "spans": {"solve": 4.0, "plan": 0.5, "chordal": 0.3,
                         "rounds": 3.2}},
              {"seconds": 1.5, "profiled": False,
               "counters": {"rounds": 30, "switch_round": 20},
               "spans": {"solve": 1.5, "plan": 0.6, "chordal": 0.4,
                         "rounds": 0.8}}]
    events = [("void gemv", 0.0, 1.0e6)]
    host = [("solve", 0.0, 4.0e6), ("rounds", 0.8e6, 4.0e6)]
    return tracing.Trace("rbcd", solves, events, host, window_s=4.0)


# span times come from the solves the profiler did not slow
EXPECTED = {
    "plan_s.central": 0.3,
    "chordal_s.central": 1.1,
    "rtr_s.central": 0.8,
    "tcg_iters.central": 415.0,
    "edge_matvec_roofline.central":
        100 * 410 * roofline.edge_matvec_bound(92595, 100000, 15, 3)[0]
        / (410 * 20e-6),
    "idle_share.central": 100 * (1 - (410 * 20e-6 + 1.0 + 10e-6) / 2.0),
    "plan_s.team": 0.6,
    "chordal_s.team": 0.4,
    "round_ms.team": 1e3 * 0.8 / 30,
    "rounds.team": 80.0,
    "idle_share.team": 75.0,
}
# the small-graph cell reads the centralized solve's layers alike
EXPECTED.update({name.replace(".central", ".small"): value
                 for name, value in EXPECTED.items()
                 if name.endswith(".central") and "roofline" not in name})


def test_every_per_layer_metric_has_a_reader_and_an_expectation(bench):
    names = [m["name"] for m in bench["per_layer"]]
    assert sorted(names) == sorted(EXPECTED)
    for name in names:
        assert os.path.exists(os.path.join(run.HERE, "metrics", name + ".py"))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_figure(name):
    metric = run.load("metrics", name)
    central, team = central_trace(), team_trace()
    mine, other = (team, central) if name.endswith(".team") else (central, team)
    assert metric.read(mine) == pytest.approx(EXPECTED[name], rel=1e-12)
    assert metric.read(other) is None


def test_readers_find_nothing_without_device_events():
    bare = central_trace()
    bare.device_events = []
    for name in ("edge_matvec_roofline.central", "idle_share.central"):
        assert run.load("metrics", name).read(bare) is None
    warm = team_trace().solves
    for s in warm:
        del s["spans"]["chordal"]
    assert run.load("metrics", "chordal_s.team").read(
        tracing.Trace("rbcd", warm, [], [], 0.0)) is None


def test_roofline_bound_is_the_h100_byte_bound():
    t, by = roofline.edge_matvec_bound(92595, 100000, 15, 3)
    assert by == "bytes"
    assert t == pytest.approx(26948368 / 3.35e12)


def test_breakdown_names_gaps_by_the_open_span():
    br = tracing.breakdown(central_trace())
    assert br["device_ops"][0][0] == "Memcpy DtoD"
    assert len(br["device_ops"]) == 3 and len(br["idle_gaps"]) == 10
    # the 1.1-1.99 s gap of the solve has its middle in the rtr span
    assert br["idle_gaps"][0] == ["rtr", pytest.approx(0.89)]


def test_each_cell_reports_what_its_metrics_move(bench):
    for cell in bench["workloads"]:
        solve = run.solve_metrics(bench, cell["name"])
        assert len(solve) == 1
        reports = solve + ["setup_s"]
        layer = run.per_layer_names(bench, cell["name"], reports)
        assert layer
        for m in bench["per_layer"]:
            if m["name"] in layer:
                assert m["moves"] in reports
