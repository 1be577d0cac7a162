"""Small sizes of the benchmark's cells, for the CPU."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

# a small world of each family, the cells' churn
TINY = {
    "central.city2d-3500": {"world": "city2d", "num_poses": 600,
                            "world_seed": 0, "withhold": 0.01,
                            "pool": 3, "start": "cold"},
    "rbcd-team8.grid3d-10k": {"world": "grid3d", "num_poses": 216,
                              "world_seed": 1, "withhold": 0.01,
                              "pool": 3, "start": "cold"},
    "rbcd-team8.grid3d-10k-warm": {"world": "grid3d", "num_poses": 216,
                                   "world_seed": 1, "withhold": 0.01,
                                   "pool": 3, "start": "warm",
                                   "previous_withhold": 0.05},
}
SEED = 2**33 + 12345  # wider than 32 bits, as the driver's seeds may be


@pytest.fixture(scope="session")
def bench():
    return run.read_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture(autouse=True)
def one_thread():
    # the tiny problems run fastest, and steadiest, on one intra-op thread
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(bench, workload, trace=False, seconds=0.5):
    return run.run_cell(bench, workload, SEED, seconds, trace,
                        torch.device("cpu"), mix=TINY[workload])
