"""The benchmark's own copy of the program's world generators.

synthesize_grid3d and synthesize_city2d are copied from
dpgo_tpu_torch/datasets.py, so that a later change to the package cannot
move the yardstick: the same seed gives the same graph, edge for edge, as
the package's generator at the time the benchmark was defined
(benchmark/tests/test_traffic.py holds them to it). They return plain
numpy arrays in an `Edges` tuple, with the field names of the package's
EdgeArrays; the odometry chain i -> i + 1 comes first, and fixed_weight
marks it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Edges(NamedTuple):
    r1: np.ndarray
    r2: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    R: np.ndarray
    t: np.ndarray
    kappa: np.ndarray
    tau: np.ndarray
    weight: np.ndarray
    fixed_weight: np.ndarray

    @property
    def m(self) -> int:
        return len(self.p1)

    @property
    def d(self) -> int:
        return self.R.shape[-1]

    def subset(self, keep: np.ndarray) -> "Edges":
        """The edges where `keep` (a bool mask) is true, as new arrays."""
        return Edges(*(np.ascontiguousarray(a[keep]) for a in self))


def _random_rotations(rng: np.random.Generator, m: int, scale: float) -> np.ndarray:
    A = scale * rng.standard_normal((m, 3, 3))
    M = np.tile(np.eye(3), (m, 1, 1)) + A
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U @ Vt)
    U[:, :, -1] *= np.sign(det)[:, None]
    return U @ Vt


def _edges(i_all, j_all, R_meas, t_meas, kappa, tau) -> Edges:
    m = len(i_all)
    return Edges(
        r1=np.zeros(m, np.int32), r2=np.zeros(m, np.int32),
        p1=i_all.astype(np.int32), p2=j_all.astype(np.int32),
        R=R_meas, t=t_meas,
        kappa=np.full(m, kappa), tau=np.full(m, tau), weight=np.ones(m),
        fixed_weight=(i_all + 1 == j_all),
    )


def synthesize_grid3d(num_poses: int, kappa: float = 100.0, tau: float = 10.0,
                      rot_noise: float = 0.02, tran_noise: float = 0.02,
                      lc_fraction: float = 0.8, seed: int = 0) -> Edges:
    """SE(3) grid world: a snake path through an s^3 grid (odometry) plus
    loop closures between grid neighbours far apart along the path."""
    rng = np.random.default_rng(seed)
    s = int(round(num_poses ** (1.0 / 3.0)))
    while s**3 < num_poses:
        s += 1
    coords = []
    for zi in range(s):
        for yi in range(s):
            xs = np.arange(s) if (zi * s + yi) % 2 == 0 else np.arange(s)[::-1]
            for xi in xs:
                coords.append((xi, yi, zi))
    coords = np.array(coords[:num_poses], dtype=np.float64)
    n = num_poses
    R_true = _random_rotations(rng, n, 1.0)
    t_true = coords
    cell_index = -np.ones((s, s, s), dtype=np.int64)
    ci = coords.astype(np.int64)
    cell_index[ci[:, 0], ci[:, 1], ci[:, 2]] = np.arange(n)
    io = np.arange(n - 1)
    jo = io + 1
    lc_pairs = []
    for axis in range(3):
        nb = ci.copy()
        nb[:, axis] += 1
        valid = nb[:, axis] < s
        src = np.arange(n)[valid]
        dst = cell_index[nb[valid, 0], nb[valid, 1], nb[valid, 2]]
        ok = (dst >= 0) & (np.abs(dst - src) > 1)
        a = np.minimum(src[ok], dst[ok])
        b = np.maximum(src[ok], dst[ok])
        lc_pairs.append(np.stack([a, b], axis=1))
    lc = np.unique(np.concatenate(lc_pairs, axis=0), axis=0)
    keep = rng.random(len(lc)) < lc_fraction
    lc = lc[keep]
    i_all = np.concatenate([io, lc[:, 0]])
    j_all = np.concatenate([jo, lc[:, 1]])
    m = len(i_all)
    Ri = R_true[i_all]
    Rj = R_true[j_all]
    R_rel = np.einsum("mba,mbc->mac", Ri, Rj)
    noise_R = _random_rotations(rng, m, rot_noise)
    R_meas = np.einsum("mab,mbc->mac", R_rel, noise_R)
    t_rel = np.einsum("mba,mb->ma", Ri, t_true[j_all] - t_true[i_all])
    t_meas = t_rel + tran_noise * rng.standard_normal((m, 3))
    return _edges(i_all, j_all, R_meas, t_meas, kappa, tau)


def synthesize_city2d(num_poses: int, kappa: float = 50.0, tau: float = 5.0,
                      rot_noise: float = 0.01, tran_noise: float = 0.05,
                      lc_per_pose: float = 1.05, min_gap: int = 10,
                      p_turn: float = 0.2, seed: int = 0) -> Edges:
    """SE(2) Manhattan world (the city10000 family): a vehicle random-walking
    a bounded street grid, odometry plus loop closures between far-apart
    revisits of one cell."""
    rng = np.random.default_rng(seed)
    n = num_poses
    s = max(8, int(round(np.sqrt(n) / 4.0)))
    turns = rng.random(n)
    turn_dir = rng.integers(0, 2, n) * 2 - 1
    DX = np.array([1, 0, -1, 0])
    DY = np.array([0, 1, 0, -1])
    pos = np.empty((n, 2), np.int64)
    head = np.empty(n, np.int64)
    x = y = s // 2
    h = 0
    for k in range(n):
        pos[k] = (x, y)
        head[k] = h
        if turns[k] < p_turn:
            h = (h + turn_dir[k]) % 4
        for _ in range(4):
            nx, ny = x + DX[h], y + DY[h]
            if 0 <= nx < s and 0 <= ny < s:
                break
            h = (h + 1) % 4
        x, y = x + DX[h], y + DY[h]
    theta = head * (np.pi / 2.0)
    c, si = np.cos(theta), np.sin(theta)
    R_true = np.stack(
        [np.stack([c, -si], axis=-1), np.stack([si, c], axis=-1)], axis=-2)
    t_true = pos.astype(np.float64)
    cell = pos[:, 0] * s + pos[:, 1]
    order = np.argsort(cell, kind="stable")
    cs = cell[order]
    same = cs[1:] == cs[:-1]
    a = order[:-1][same]
    b = order[1:][same]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    ok = hi - lo >= min_gap
    lo, hi = lo[ok], hi[ok]
    target = int(lc_per_pose * n)
    if len(lo) > target:
        pick = rng.choice(len(lo), target, replace=False)
        pick.sort()
        lo, hi = lo[pick], hi[pick]
    i_all = np.concatenate([np.arange(n - 1), lo])
    j_all = np.concatenate([np.arange(1, n), hi])
    m = len(i_all)
    Ri = R_true[i_all]
    Rj = R_true[j_all]
    R_rel = np.einsum("mba,mbc->mac", Ri, Rj)
    ang = rot_noise * rng.standard_normal(m)
    ca, sa = np.cos(ang), np.sin(ang)
    noise_R = np.stack(
        [np.stack([ca, -sa], axis=-1), np.stack([sa, ca], axis=-1)], axis=-2)
    R_meas = np.einsum("mab,mbc->mac", R_rel, noise_R)
    t_rel = np.einsum("mba,mb->ma", Ri, t_true[j_all] - t_true[i_all])
    t_meas = t_rel + tran_noise * rng.standard_normal((m, 2))
    return _edges(i_all, j_all, R_meas, t_meas, kappa, tau)


WORLDS = {"grid3d": synthesize_grid3d, "city2d": synthesize_city2d}
