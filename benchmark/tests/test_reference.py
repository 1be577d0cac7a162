"""The plain reference against the program's own objective, in float64."""

import pytest
import torch

from benchmark.harness import worlds
from benchmark.reference import objective
from dpgo_tpu_torch import measurements, quadratic


@pytest.mark.parametrize("family, n, r", [("grid3d", 125, 5),
                                          ("city2d", 300, 5),
                                          ("city2d", 300, 2)])
def test_reference_matches_quadratic(family, n, r):
    edges = worlds.WORLDS[family](n, seed=2)
    gen = torch.Generator().manual_seed(0)
    edges = edges._replace(weight=0.5 + torch.rand(
        edges.m, generator=gen, dtype=torch.float64).numpy())
    d = edges.d
    M = torch.randn(n, r, d, generator=gen, dtype=torch.float64)
    Y = torch.linalg.qr(M).Q
    p = 10.0 * torch.randn(n, r, generator=gen, dtype=torch.float64)
    X = torch.cat([Y, p[..., None]], dim=-1)
    problem = quadratic.from_private_measurements(
        measurements.EdgeArrays(**edges._asdict()), n=n, d=d, device="cpu")
    qd = quadratic.build_quadratic_data(
        problem, torch.zeros((1, r, d + 1), dtype=torch.float64), r=r)
    ref = objective.readings(edges, X)
    f = float(quadratic.cost(qd, X))
    g = float(quadratic.rie_grad_norm(qd, X))
    assert abs(ref["cost"] - f) <= 1e-10 * abs(f)
    assert abs(ref["gradnorm"] - g) <= 1e-10 * abs(g)
    assert ref["orthonormality"] < 1e-13


def test_reference_blocks_sum_to_the_whole(monkeypatch):
    edges = worlds.synthesize_city2d(300, seed=4)
    X = torch.randn(300, 4, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    whole = objective.readings(edges, X)
    monkeypatch.setattr(objective, "BLOCK", 97)
    blocked = objective.readings(edges, X)
    for k in whole:
        assert blocked[k] == pytest.approx(whole[k], rel=1e-12)
