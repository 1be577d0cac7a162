"""The SE(3) delta-team cell on the CPU at small size: a sound run is
correct, traced and untraced; the control and each fault the delta city's
cell plants are not correct in any solve; the cell's nine readers read
their figures from a recorded fake trace."""

import collections
import os

import pytest
import torch

from benchmark import calibrate, run
from benchmark.harness import tracing
from benchmark.tests.conftest import SEED
from benchmark.tests.test_delta_cell import plant
from dpgo_tpu_torch import trace
from dpgo_tpu_torch.parallel import delta

CELL = "delta-team8.grid3d-10k"
# the cell's own small mix: a grid of 343 poses, 43 a robot (tridiagonal
# preconditioner, d = 3 Newton-Schulz polars, tCG cap 20)
MIX = {"world": "grid3d", "num_poses": 343, "world_seed": 1,
       "withhold": 0.01, "pool": 3, "start": "cold"}
# a fault keeps the host's gradient norm above the tolerance; the small
# team's sound solves take ~35 rounds
MAX_ROUNDS = 200


def config():
    cfg = run.read_json(os.path.join(run.HERE, "configs", "delta-team8.json"))
    cfg["delta"] = dict(cfg["delta"], max_rounds=MAX_ROUNDS)
    return cfg


def tiny_run(bench, trace=False, seconds=0.5):
    return run.run_cell(bench, CELL, SEED, seconds, trace,
                        torch.device("cpu"), config=config(), mix=MIX)


def test_the_configuration_is_the_3d_schedule():
    cfg = config()
    assert cfg["engine"] == "delta" and cfg["num_agents"] == 8
    assert cfg["spmd"]["rtr_tcg_iterations"] == 20
    assert "rtr_tcg_precision" not in cfg["spmd"]
    assert cfg["reduced"] == []


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(bench, traced):
    res = tiny_run(bench, traced)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["check"]["orthonormality"]["value"] <= 1e-12
    reports = run.solve_metrics(bench, CELL) + ["setup_s"]
    assert reports == ["team_solve_s", "setup_s"]
    if traced:
        # on the CPU the device-trace metric has nothing to read
        expected = {n for n in run.per_layer_names(bench, CELL, reports)
                    if n != "idle_share.delta3d"}
        assert len(expected) == 8 and set(res["metrics"]) == expected
        assert res["metrics"]["polar_steps.delta3d"]["value"] >= 0
    else:
        assert set(res["metrics"]) == set(reports)


def test_control_is_not_correct(bench):
    """The anchor in float32, the precision below the configuration's."""
    rows = calibrate.readings(bench, CELL, 2, True, torch.device("cpu"),
                              config=config(), mix=MIX)
    assert not any(r["readings"]["ok"] for r in rows)


def plant3d(monkeypatch, fault):
    """test_delta_cell's faults; the stale exchange keyed by the shared
    edges' count too, which differs between the grid's instances."""
    if fault != "exchange":
        return plant(monkeypatch, fault)
    gather = delta._gather_nbr
    first = {}

    def stale(pr, D, mesh=delta.LOCAL):
        # every robot keeps the neighbor deltas of the first exchange
        key = (D.dtype, tuple(D.shape), tuple(pr.shared_nbr_slot.shape))
        if key not in first:
            first[key] = gather(pr, D, mesh)
        return first[key]
    monkeypatch.setattr(delta, "_gather_nbr", stale)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "exchange",
                                   "no_acc", "altered"])
def test_fault_is_not_correct(bench, monkeypatch, fault):
    """Each fault the delta city's cell plants, planted under a run."""
    plant3d(monkeypatch, fault)
    res = tiny_run(bench)
    assert not res["correct"], res["check"]
    assert res["failed"] == res["attempted"]


def delta3d_trace():
    solves = [{"seconds": 25.0, "profiled": True,
               "counters": {"rounds": 130, "calls": 1},
               "spans": {"solve": 25.0, "plan": 0.5, "chordal": 0.6,
                         "rounds": 23.9}},
              {"seconds": 19.0, "profiled": False,
               "counters": {"rounds": 120, "calls": 1},
               "spans": {"solve": 19.0, "plan": 0.4, "chordal": 0.5,
                         "rounds": 18.1}}]
    events = [("void gemv", 0.0, 2.5e6)]
    host = [("solve", 0.0, 25.0e6), ("rounds", 1.1e6, 25.0e6)]
    return tracing.Trace("delta", solves, events, host, window_s=25.0)


COUNTS = collections.Counter({
    "sync.delta.polar": 440, "sync.delta.shrink": 250, "sync.delta.round": 250,
    "sync.delta.check": 8, "sync.rtr.tcg": 4300, "sync.rtr.control": 0,
    "sync.plan": 20, "sync.chordal.pcg": 900, "delta.rounds": 250,
    "delta.polar_calls": 750, "delta.polar_steps": 570,
    "chordal.pcg_iters": 910, "chordal.solves": 2})

EXPECTED = {
    "plan_s.delta3d": 0.4,
    "chordal_s.delta3d": 0.5,
    "pcg_iters.delta3d": 455.0,
    "round_ms.delta3d": 1e3 * 18.1 / 120,
    "rounds.delta3d": 125.0,
    "syncs_per_round.delta3d": (440 + 250 + 250 + 8 + 4300) / 250,
    "tcg_per_round.delta3d": 4300 / 250,
    "polar_steps.delta3d": 570 / 750,
    "idle_share.delta3d": 90.0,
}


def test_the_cells_readers_are_listed(bench):
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["moves"] == "team_solve_s"
    assert sorted(run.per_layer_names(bench, CELL, ["team_solve_s"])) == \
        sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_figure(monkeypatch, name):
    metric = run.load("metrics", name)
    monkeypatch.setattr(trace, "COUNTS", COUNTS)
    assert metric.read(delta3d_trace()) == pytest.approx(EXPECTED[name],
                                                         rel=1e-12)
    other = delta3d_trace()
    other.engine = "rbcd"
    assert metric.read(other) is None


def test_polar_steps_reads_nothing_without_the_counters(monkeypatch):
    """A program that does not count the polar's steps (the benchmark laid
    over an older checkout): the reader returns None and raises nothing."""
    old = collections.Counter({k: v for k, v in COUNTS.items()
                               if not k.startswith("delta.polar_")})
    monkeypatch.setattr(trace, "COUNTS", old)
    metric = run.load("metrics", "polar_steps.delta3d")
    assert metric.read(delta3d_trace()) is None
