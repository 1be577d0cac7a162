"""The one traffic generator: a mix file of parameters -> the solves' inputs.

A mix (benchmark/traffic/<name>.json) names a world family of worlds.py,
its size and the seed of the world itself, and the loop-closure churn:

    {"world": "city2d", "num_poses": 100000, "world_seed": 0,
     "withhold": 0.01, "pool": 8, "start": "cold"}

The world is one fixed map, as a public data set is one fixed graph. Its
instances are the map with a `withhold` share of its loop closures left
out: `pool` of them, drawn from the world seed, so that every run seed
gets the same set of instances, and so the same work, in another order.
The window's solves walk through the pool, each pass in a fresh order
drawn from the run seed. "start": "warm" adds a previous map, the world
without a `previous_withhold` share of its loop closures, which set-up
solves once and every timed solve starts from. The warm-up solve takes an
instance outside the pool, drawn from the run seed.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.worlds import WORLDS, Edges

# streams of draws from one seed
POOL, WARMUP, PREVIOUS, ORDER = 0, 1, 2, 3


def world(mix: dict) -> Edges:
    return WORLDS[mix["world"]](mix["num_poses"], seed=mix["world_seed"])


def _rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream, index])


def keep_mask(edges: Edges, fraction: float, rng: np.random.Generator) -> np.ndarray:
    """Bool mask over the edges: every odometry edge, and all loop closures
    but round(fraction * count) drawn by rng."""
    lc = np.flatnonzero(~edges.fixed_weight)
    out = rng.choice(len(lc), int(round(fraction * len(lc))), replace=False)
    keep = np.ones(edges.m, bool)
    keep[lc[out]] = False
    return keep


def pool_index(mix: dict, seed: int, solve: int) -> int:
    """The pool instance of the window's solve number `solve`."""
    p = mix["pool"]
    order = _rng(seed, ORDER, solve // p).permutation(p)
    return int(order[solve % p])


def instance(edges: Edges, mix: dict, k: int) -> Edges:
    """Pool instance k."""
    return edges.subset(keep_mask(edges, mix["withhold"],
                                  _rng(mix["world_seed"], POOL, k)))


def warmup(edges: Edges, mix: dict, seed: int) -> Edges:
    return edges.subset(keep_mask(edges, mix["withhold"],
                                  _rng(seed, WARMUP, 0)))


def previous_map(edges: Edges, mix: dict) -> Edges:
    """The warm mix's previous map."""
    return edges.subset(keep_mask(edges, mix["previous_withhold"],
                                  _rng(mix["world_seed"], PREVIOUS, 0)))
