"""A run of the benchmark on the CPU at small sizes: it refuses to run
without a card, a sound run is correct, and the comparison that decides
`correct` fails the control and each fault the cells can have."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests.conftest import TINY, tiny_run
from dpgo_tpu_torch import quadratic
from dpgo_tpu_torch.parallel import spmd
from dpgo_tpu_torch.solvers import rtr


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "central.city2d-3500", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=run.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(bench, workload, trace):
    res = tiny_run(bench, workload, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert set(res["check"]) == {"gradnorm", "orthonormality",
                                 "missed_tolerance"}
    reports = run.solve_metrics(bench, workload) + ["setup_s"]
    if trace:
        # on the CPU the device-trace metrics have nothing to read
        expected = {n for n in run.per_layer_names(bench, workload, reports)
                    if not n.startswith(("idle_share", "edge_matvec"))}
        assert expected and set(res["metrics"]) == expected
    else:
        assert set(res["metrics"]) == set(reports)


@pytest.mark.parametrize("workload", ["central.city2d-3500",
                                      "rbcd-team8.grid3d-10k"])
def test_control_is_not_correct(bench, workload):
    """The program in float32, the precision below the configuration's."""
    rows = calibrate.readings(bench, workload, 2, True, torch.device("cpu"),
                              mix=TINY[workload])
    assert not any(r["readings"]["ok"] for r in rows)


def half_of_the_loop_closures(edges):
    """Every other loop closure left out, the rest weighted double."""
    lc = ~edges.fixed_weight
    drop = lc & (edges.p1 % 2 == 0)
    weight = edges.weight * (1 + lc)
    keep = ~drop
    return type(edges)(**{f: getattr(edges, f)[keep] if f != "weight"
                          else weight[keep] for f in edges.__dataclass_fields__})


def central_fault(monkeypatch, fault):
    real = rtr.rtr_solve
    if fault == "unchanged":
        monkeypatch.setattr(rtr, "rtr_solve", lambda qd, Y0, **kw:
                            (Y0, real(qd, Y0, **kw)[1]))
    elif fault == "altered":
        def altered(qd, Y0, **kw):
            X, stats = real(qd, Y0, **kw)
            X = X.clone()
            X[0, :, -1] += 0.1
            return X, stats
        monkeypatch.setattr(rtr, "rtr_solve", altered)
    elif fault == "half_batch":
        build = quadratic.from_private_measurements
        monkeypatch.setattr(quadratic, "from_private_measurements",
                            lambda edges, **kw: build(
                                half_of_the_loop_closures(edges), **kw))


def team_fault(monkeypatch, fault):
    make = spmd.make_two_phase_run_fn
    if fault in ("unchanged", "altered"):
        def make_faulty(problem, cfg, **kw):
            real = make(problem, cfg, **kw)

            def run_(state0, max_rounds, tol):
                state, metrics, rounds = real(state0, max_rounds, tol)
                if fault == "unchanged":
                    return state0, metrics, rounds
                X = state.X.clone()
                X[0, 0, :, -1] += 0.1
                return state._replace(X=X), metrics, rounds
            run_.switch_round = None
            return run_
        monkeypatch.setattr(spmd, "make_two_phase_run_fn", make_faulty)
    elif fault == "half_batch":
        from dpgo_tpu_torch.measurements import EdgeArrays
        build = spmd.build_spmd_problem

        def half(meas, *a, **kw):
            edges = half_of_the_loop_closures(EdgeArrays.from_measurements(meas))
            return build(edges.to_measurements(), *a, **kw)
        monkeypatch.setattr(spmd, "build_spmd_problem", half)
    elif fault == "exchange":
        gather = spmd._gather_pub
        first = {}

        def stale(X, pub_idx):
            # every robot keeps the public poses of the first exchange
            key = (X.dtype, tuple(X.shape))
            if key not in first:
                first[key] = gather(X, pub_idx)
            return first[key]
        monkeypatch.setattr(spmd, "_gather_pub", stale)


@pytest.mark.parametrize("workload, fault", [
    ("central.city2d-3500", "unchanged"),
    ("central.city2d-3500", "half_batch"),
    ("central.city2d-3500", "altered"),
    ("rbcd-team8.grid3d-10k", "unchanged"),
    ("rbcd-team8.grid3d-10k", "half_batch"),
    ("rbcd-team8.grid3d-10k", "exchange"),
    ("rbcd-team8.grid3d-10k", "altered"),
    ("rbcd-team8.grid3d-10k-warm", "exchange"),
])
def test_fault_is_not_correct(bench, monkeypatch, workload, fault):
    """Each fault the cell can have, planted under a run."""
    if workload.startswith("central"):
        central_fault(monkeypatch, fault)
    else:
        team_fault(monkeypatch, fault)
    res = tiny_run(bench, workload)
    assert not res["correct"], res["check"]
    assert res["failed"] == res["attempted"]


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, torch; from benchmark import run; "
            "from benchmark.tests.conftest import TINY; "
            "bench = run.read_json('BENCHMARK.json'); "
            "w = 'rbcd-team8.grid3d-10k'; "
            "res = run.run_cell(bench, w, 3, 0.2, True, torch.device('cpu'), "
            "mix=TINY[w]); "
            "assert res['correct']; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'dpgo_tpu')]; "
            "assert not bad, bad")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
