"""The certified-solve cell on the CPU at small size: a sound run is correct,
traced and untraced; the control and each planted fault (the certificate's
S-action in float32, "certified" forced on a rejected point, the polish
skipped) are not; the cell's eight readers read their figures from a
recorded fake trace."""

import collections
import os

import numpy as np
import pytest
import torch

from benchmark import calibrate, run
from benchmark.harness import tracing, worlds
from benchmark.tests.conftest import SEED
from dpgo_tpu_torch import trace
from dpgo_tpu_torch.measurements import EdgeArrays
from dpgo_tpu_torch.solvers import certify
from dpgo_tpu_torch.solvers.pgo import odometry_initialization

CELL = "sesync-cert.grid3d-10k"
# the cell's own small mix: a grid of 216 poses (under 4,096 gather-path
# edges, so no CSR plans), the 10k mix's world seed and churn
MIX = {"world": "grid3d", "num_poses": 216, "world_seed": 1,
       "withhold": 0.01, "pool": 3, "start": "cold"}


def config():
    return run.read_json(os.path.join(run.HERE, "configs", "sesync-cert.json"))


def short(cfg):
    """cfg with the budgets a fault runs into cut (the polish's iterations,
    the refinement's), so that a faulty solve ends sooner; a sound one
    stays inside both."""
    return dict(cfg, polish=dict(cfg["polish"], max_iterations=10),
                certificate=dict(cfg["certificate"], refine_iters=60))


def tiny_run(bench, trace=False, seconds=0.5, cfg=None):
    return run.run_cell(bench, CELL, SEED, seconds, trace,
                        torch.device("cpu"), config=cfg or config(), mix=MIX)


def test_the_configuration_is_sesync_certified():
    cfg = config()
    assert cfg["engine"] == "certified" and cfg["r"] == 5
    assert cfg["r_max"] == 10 and cfg["reduced"] == []
    assert cfg["precision"] == {"iterate": "float64", "tcg": "float32",
                                "chordal_cg": "float32",
                                "polish": "float64",
                                "certificate": "float64"}
    assert cfg["certificate"] == {"k": 64, "eta": 1e-6, "refine_iters": 400,
                                  "precond": "auto"}
    assert cfg["polish"] == dict(certify.POLISH)
    assert cfg["limits"]["gradnorm"] == cfg["polish"]["gradnorm_tol"]


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(bench, traced):
    res = tiny_run(bench, traced)
    # a sound solve stays inside short()'s budgets
    cut = short(config())
    counters = res["solves"]["counters"]
    assert max(counters["refine_iters"]) < cut["certificate"]["refine_iters"]
    assert max(counters["polish_iters"]) < cut["polish"]["max_iterations"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["check"]["gradnorm"]["value"] <= 1e-6
    reports = run.solve_metrics(bench, CELL) + ["setup_s"]
    assert reports == ["small_solve_s", "setup_s"]
    if traced:
        # on the CPU the device-trace metric has nothing to read
        expected = {n for n in run.per_layer_names(bench, CELL, reports)
                    if n != "idle_share.cert"}
        assert len(expected) == 7 and set(res["metrics"]) == expected
    else:
        assert set(res["metrics"]) == set(reports)


def test_control_is_not_correct(bench):
    """The iterate, the polish and the certificate in float32, the
    precision below the configuration's."""
    rows = calibrate.readings(bench, CELL, 2, True, torch.device("cpu"),
                              config=short(config()), mix=MIX)
    assert not any(r["readings"]["ok"] for r in rows)


def test_float32_s_action_is_not_correct(bench, monkeypatch):
    """The certificate's S-action in float32, everything around it float64:
    the program's stationarity and Ritz pair no longer match the
    reference's."""
    real = certify.certificate_matvec

    def float32(qd, Lam, V):
        return real(qd.to(torch.float32), Lam.float(), V.float()).to(V.dtype)
    monkeypatch.setattr(certify, "certificate_matvec", float32)
    res = tiny_run(bench, cfg=short(config()))
    assert not res["correct"]
    assert res["failed"] == res["attempted"] >= 1


def test_skipped_polish_is_not_correct(bench, monkeypatch):
    """The polish returns its input: the answer stays at the loose
    tolerance of the mixed solve."""
    real = certify.polish
    monkeypatch.setattr(certify, "polish",
                        lambda qd, X, dtype=None, **s: real(
                            qd, X, dtype, **dict(s, max_iterations=0)))
    res = tiny_run(bench)
    assert not res["correct"]
    assert res["check"]["gradnorm"]["value"] > 1e-6
    assert res["failed"] == res["attempted"] >= 1


def ring_edges(n=12, lc_angle=np.pi):
    """tests/test_certify.py's SE(2) ring whose loop closure contradicts the
    odometry, as a benchmark Edges tuple: from the odometry start the rank-2
    solve stops at a suboptimal critical point."""
    theta = 2 * np.pi / n

    def rot(a):
        return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])

    i = np.arange(n)
    R = np.stack([rot(theta)] * (n - 1) + [rot(lc_angle)])
    return worlds._edges(i, (i + 1) % n, R, np.tile([1.0, 0.0], (n, 1)),
                         10.0, 10.0)


def test_forced_certificate_is_refuted(monkeypatch):
    """"certified" forced on the ring's rejected r = 2 point (lambda_min
    below -1e-2): the reference's own Lanczos finds the negative eigenvalue
    and the answer is not converged."""
    e = ring_edges()
    arrays = EdgeArrays(**e._asdict())
    T0 = odometry_initialization(arrays.to_measurements()[:-1], device="cpu")
    real = certify.min_eig_certificate
    seen = []

    def forced(*args, **kwargs):
        c = real(*args, **kwargs)
        seen.append(c)
        return c._replace(certified=True)
    monkeypatch.setattr(certify, "min_eig_certificate", forced)
    cfg = dict(config(), r=2, r_max=2)
    engine = run.load("engines", "certified").Engine(cfg, torch.device("cpu"))
    res = certify.solve_certified(arrays, 12, 2, X0=T0, r_max=2,
                                  certificate=cfg["certificate"],
                                  device="cpu")
    assert res.r == 2 and not seen[0].certified
    assert seen[0].lambda_min < -1e-2
    _, counters = engine.answer((res, e, 0))
    assert counters["certified"] == 1 and counters["rho"] < -1e-2
    assert not counters["converged"] and counters["agrees"] == 0


def cert_trace():
    solves = [{"seconds": 3.0, "profiled": True, "counters": {"rank": 5},
               "spans": {"solve": 3.0, "plan": 0.3, "chordal": 0.2,
                         "rtr": 0.5, "polish": 0.6, "certificate": 1.4}},
              {"seconds": 2.5, "profiled": False, "counters": {"rank": 5},
               "spans": {"solve": 2.5, "plan": 0.2, "chordal": 0.1,
                         "rtr": 0.4, "polish": 0.5, "certificate": 1.3}}]
    events = [("void gemv", 0.0, 0.6e6)]
    host = [("solve", 0.0, 3.0e6), ("certificate", 1.6e6, 3.0e6)]
    return tracing.Trace("certified", solves, events, host, window_s=3.0)


COUNTS = collections.Counter({
    "sync.certify": 18, "sync.certify.refine": 804, "sync.rtr.tcg": 1400,
    "sync.rtr.control": 40, "sync.plan": 12, "sync.chordal.pcg": 60,
    "certify.solves": 2, "certify.calls": 2, "certify.lanczos_steps": 128,
    "certify.refine_iters": 800, "rtr.solves": 4})

EXPECTED = {
    "plan_s.cert": 0.2,
    "chordal_s.cert": 0.1,
    "rtr_s.cert": 0.4,
    "polish_s.cert": 0.5,
    "certificate_s.cert": 1.3,
    "refine_iters.cert": 400.0,
    "host_syncs.cert": (18 + 804 + 1400 + 40 + 12 + 60) / 2,
    "idle_share.cert": 80.0,
}


def test_the_cells_readers_are_listed(bench):
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["moves"] == "small_solve_s"
    assert sorted(run.per_layer_names(bench, CELL, ["small_solve_s"])) == \
        sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_figure(monkeypatch, name):
    metric = run.load("metrics", name)
    monkeypatch.setattr(trace, "COUNTS", COUNTS)
    assert metric.read(cert_trace()) == pytest.approx(EXPECTED[name],
                                                      rel=1e-12)
    other = cert_trace()
    other.engine = "central"
    assert metric.read(other) is None


def test_counter_readers_read_nothing_without_the_counters(monkeypatch):
    """A program that does not count its certificates (the benchmark laid
    over an older checkout): the readers return None and raise nothing."""
    old = collections.Counter({k: v for k, v in COUNTS.items()
                               if not k.startswith("certify.")})
    monkeypatch.setattr(trace, "COUNTS", old)
    for name in ("refine_iters.cert", "host_syncs.cert"):
        assert run.load("metrics", name).read(cert_trace()) is None
