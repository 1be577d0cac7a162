"""The traffic generator: the copied worlds and the instances of a mix."""

import numpy as np
import pytest

from benchmark.harness import traffic, worlds
from dpgo_tpu_torch import datasets

MIX = {"world": "city2d", "num_poses": 3500, "world_seed": 0,
       "withhold": 0.01, "pool": 6, "start": "warm", "previous_withhold": 0.05}


@pytest.mark.parametrize("family, n, seed", [
    ("grid3d", 216, 1), ("grid3d", 1000, 7), ("city2d", 600, 0),
    ("city2d", 3500, 3)])
def test_worlds_match_the_package(family, n, seed):
    ours = worlds.WORLDS[family](n, seed=seed)
    theirs, n_theirs, _ = getattr(datasets, f"synthesize_{family}")(n, seed=seed)
    assert n_theirs == n
    for field in worlds.Edges._fields:
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(theirs, field), err_msg=field)


def test_instances_are_seeded_distinct_and_of_one_size():
    edges = traffic.world(MIX)
    n_lc = int((~edges.fixed_weight).sum())
    insts = [traffic.instance(edges, MIX, k) for k in range(MIX["pool"])]
    insts += [traffic.warmup(edges, MIX, s) for s in (2**40 + 3, 7)]
    again = traffic.instance(edges, MIX, 0)
    for f in worlds.Edges._fields:
        np.testing.assert_array_equal(getattr(insts[0], f), getattr(again, f))
    assert len({tuple(i.p1) + tuple(i.p2) for i in insts}) == len(insts)
    for inst in insts:
        assert inst.m == edges.m - round(0.01 * n_lc)
        assert inst.fixed_weight.sum() == edges.fixed_weight.sum()
    prev = traffic.previous_map(edges, MIX)
    assert prev.m == edges.m - round(0.05 * n_lc)


def test_every_seed_walks_the_whole_pool_in_its_own_order():
    p = MIX["pool"]
    orders = []
    for seed in (1, 2**33 + 5, 12345):
        order = [traffic.pool_index(MIX, seed, i) for i in range(3 * p)]
        for c in range(3):
            assert sorted(order[c * p:(c + 1) * p]) == list(range(p))
        orders.append(order)
        assert order == [traffic.pool_index(MIX, seed, i) for i in range(3 * p)]
    assert orders[0] != orders[1] != orders[2]
