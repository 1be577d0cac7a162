"""Synthetic pose-graph dataset generation.

BASELINE.json names g2o100k.g2o as the scale benchmark, but that file is
absent from the reference mount (.MISSING_LARGE_BLOBS). `synthesize_grid3d`
deterministically generates an equivalent-scale SE(3) grid-world dataset in
the same spirit as the grid3D family: a snake path visiting every cell of an
s^3 grid (odometry chain) plus loop closures between spatially adjacent cells
that are far apart along the path. All construction is vectorized numpy; the
result is an EdgeArrays directly usable by the solvers, or writable as .g2o.

A numpy copy of dpgo_tpu/datasets.py: the same seeds give the same graphs in
both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dpgo_tpu_torch.measurements import EdgeArrays


def _random_rotations(rng: np.random.Generator, m: int, scale: float) -> np.ndarray:
    """Batched small random rotations: expm of skew noise via SVD projection."""
    A = scale * rng.standard_normal((m, 3, 3))
    M = np.tile(np.eye(3), (m, 1, 1)) + A
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U @ Vt)
    U[:, :, -1] *= np.sign(det)[:, None]
    return U @ Vt


def synthesize_grid3d(
    num_poses: int,
    kappa: float = 100.0,
    tau: float = 10.0,
    rot_noise: float = 0.02,
    tran_noise: float = 0.02,
    lc_fraction: float = 0.8,
    seed: int = 0,
) -> Tuple[EdgeArrays, int, np.ndarray]:
    """Deterministic SE(3) grid-world pose graph.

    Returns (edges, num_poses, T_true) with T_true: (n, 3, 4).
    """
    rng = np.random.default_rng(seed)
    s = int(round(num_poses ** (1.0 / 3.0)))
    while s**3 < num_poses:
        s += 1
    # snake path through the grid: x fastest (alternating), then y, then z
    z, y = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    coords = []
    for zi in range(s):
        for yi in range(s):
            xs = np.arange(s) if (zi * s + yi) % 2 == 0 else np.arange(s)[::-1]
            for xi in xs:
                coords.append((xi, yi, zi))
    coords = np.array(coords[:num_poses], dtype=np.float64)
    n = num_poses

    # ground truth: translation = grid coords, random orientations
    R_true = _random_rotations(rng, n, 1.0)
    t_true = coords

    # cell -> pose index map (only for visited cells)
    cell_index = -np.ones((s, s, s), dtype=np.int64)
    ci = coords.astype(np.int64)
    cell_index[ci[:, 0], ci[:, 1], ci[:, 2]] = np.arange(n)

    # odometry chain i -> i+1
    io = np.arange(n - 1)
    jo = io + 1

    # loop closures: +x neighbors that are not path-adjacent
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

    # relative measurements with noise
    Ri = R_true[i_all]
    Rj = R_true[j_all]
    R_rel = np.einsum("mba,mbc->mac", Ri, Rj)  # Ri^T Rj
    noise_R = _random_rotations(rng, m, rot_noise)
    R_meas = np.einsum("mab,mbc->mac", R_rel, noise_R)
    t_rel = np.einsum("mba,mb->ma", Ri, t_true[j_all] - t_true[i_all])
    t_meas = t_rel + tran_noise * rng.standard_normal((m, 3))

    edges = EdgeArrays(
        r1=np.zeros(m, np.int32),
        r2=np.zeros(m, np.int32),
        p1=i_all.astype(np.int32),
        p2=j_all.astype(np.int32),
        R=R_meas,
        t=t_meas,
        kappa=np.full(m, kappa),
        tau=np.full(m, tau),
        weight=np.ones(m),
        fixed_weight=(i_all + 1 == j_all),
    )
    T_true = np.concatenate([R_true, t_true[:, :, None]], axis=-1)
    return edges, n, T_true


def synthesize_city2d(
    num_poses: int,
    kappa: float = 50.0,
    tau: float = 5.0,
    rot_noise: float = 0.01,
    tran_noise: float = 0.05,
    lc_per_pose: float = 1.05,
    min_gap: int = 10,
    p_turn: float = 0.2,
    seed: int = 0,
) -> Tuple[EdgeArrays, int, np.ndarray]:
    """Deterministic SE(2) Manhattan-world pose graph — the structure of the
    missing g2o100k / city10000 family (BASELINE.json config #5): a vehicle
    random-walking a bounded street grid, odometry chain + loop closures
    between far-apart revisits of the same cell.

    Unlike the grid3d lattice world, the loop closures here connect pose ids
    at RANDOM (revisit-time) offsets — no relabeling can concentrate them on
    a few band lanes, so the matvec's gather path does real work (band
    coverage ~= the odometry fraction, ~50%, like city10000). This is the
    non-lattice scale world the 100k certified pipeline is measured on.

    Returns (edges, num_poses, T_true) with T_true: (n, 2, 3).
    """
    rng = np.random.default_rng(seed)
    n = num_poses
    # bounded street grid sized so the walk revisits cells often enough to
    # supply ~lc_per_pose loop closures (consecutive-visit pairs per cell)
    s = max(8, int(round(np.sqrt(n) / 4.0)))

    # Manhattan walk: headings 0..3 = E,N,W,S; turn +-90deg with prob p_turn,
    # forced turns at the boundary. Sequential scalar loop (host-side, ~1 s
    # at 100k) — the walk is inherently a recurrence.
    turns = rng.random(n)
    turn_dir = rng.integers(0, 2, n) * 2 - 1  # -1 or +1
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
        # forced turn when the next step would leave the grid
        for _ in range(4):
            nx, ny = x + DX[h], y + DY[h]
            if 0 <= nx < s and 0 <= ny < s:
                break
            h = (h + 1) % 4
        x, y = x + DX[h], y + DY[h]

    theta = head * (np.pi / 2.0)
    c, si = np.cos(theta), np.sin(theta)
    R_true = np.stack(
        [np.stack([c, -si], axis=-1), np.stack([si, c], axis=-1)], axis=-2
    )  # (n, 2, 2)
    t_true = pos.astype(np.float64)

    # loop closures: consecutive visits to the same cell, min_gap apart
    cell = pos[:, 0] * s + pos[:, 1]
    order = np.argsort(cell, kind="stable")  # stable: time-ordered per cell
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

    # relative SE(2) measurements with noise
    Ri = R_true[i_all]
    Rj = R_true[j_all]
    R_rel = np.einsum("mba,mbc->mac", Ri, Rj)  # Ri^T Rj
    ang = rot_noise * rng.standard_normal(m)
    ca, sa = np.cos(ang), np.sin(ang)
    noise_R = np.stack(
        [np.stack([ca, -sa], axis=-1), np.stack([sa, ca], axis=-1)], axis=-2
    )
    R_meas = np.einsum("mab,mbc->mac", R_rel, noise_R)
    t_rel = np.einsum("mba,mb->ma", Ri, t_true[j_all] - t_true[i_all])
    t_meas = t_rel + tran_noise * rng.standard_normal((m, 2))

    edges = EdgeArrays(
        r1=np.zeros(m, np.int32),
        r2=np.zeros(m, np.int32),
        p1=i_all.astype(np.int32),
        p2=j_all.astype(np.int32),
        R=R_meas,
        t=t_meas,
        kappa=np.full(m, kappa),
        tau=np.full(m, tau),
        weight=np.ones(m),
        fixed_weight=(i_all + 1 == j_all),
    )
    T_true = np.concatenate([R_true, t_true[:, :, None]], axis=-1)
    return edges, n, T_true


def plant_outliers(measurements, num_poses: int, frac: float = 0.15,
                   seed: int = 0):
    """Corrupt a dataset with uniformly random OUTLIER loop closures — the
    robust-PGO evaluation protocol (reference semantics: the GNC pipeline of
    DPGO_solver.cpp:335-412 exists to reject exactly such edges; the
    reference repo never ships a corrupted dataset, so the planting is ours).

    Adds round(frac * n_lc) fake loop closures (n_lc = genuine non-odometry
    edge count) between uniformly random pose pairs with uniformly random
    relative rotation and a translation drawn at the scale of the genuine
    loop closures; kappa/tau are the genuine loop closures' medians, so the
    outliers claim full confidence. Planted pairs are unique and disjoint
    from genuine edges.

    Returns (corrupted_list, planted) where planted is a set of ORDERED
    global (p1, p2) pairs identifying the fakes.
    """
    rng = np.random.default_rng(seed)
    lcs = [m for m in measurements if m.p2 - m.p1 != 1 or m.r1 != m.r2]
    if not lcs:
        lcs = list(measurements)
    d = measurements[0].d
    n_out = int(round(frac * len(lcs)))
    kappa = float(np.median([m.kappa for m in lcs]))
    tau = float(np.median([m.tau for m in lcs]))
    t_scale = float(np.median([np.linalg.norm(m.t) for m in lcs])) + 1.0
    existing = {(m.p1, m.p2) for m in measurements}
    existing |= {(m.p2, m.p1) for m in measurements}
    planted = set()
    out = [m.copy() for m in measurements]
    while len(planted) < n_out:
        i = int(rng.integers(0, num_poses - 2))
        j = int(rng.integers(i + 2, num_poses))
        if (i, j) in existing or (i, j) in planted:
            continue
        if d == 2:
            th = rng.uniform(-np.pi, np.pi)
            R = np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
        else:
            A = rng.standard_normal((3, 3))
            U, _, Vt = np.linalg.svd(A)
            R = U @ Vt
            if np.linalg.det(R) < 0:
                U[:, -1] *= -1.0
                R = U @ Vt
        t = rng.uniform(-2.0 * t_scale, 2.0 * t_scale, size=d)
        from dpgo_tpu_torch.measurements import RelativeSEMeasurement

        out.append(RelativeSEMeasurement(
            r1=0, r2=0, p1=i, p2=j, R=R, t=t, kappa=kappa, tau=tau,
            weight=1.0, fixed_weight=False,
        ))
        planted.add((i, j))
    return out, planted


def write_g2o(edges: EdgeArrays, path: str) -> None:
    """Write SE(3) edges as EDGE_SE3:QUAT records with isotropic information
    (kappa on the rotation block, tau on translation, matching the parser's
    inverse conventions only approximately — intended for round-trip testing
    and external-tool interop)."""
    assert edges.d == 3
    from dpgo_tpu_torch.io.g2o import _rot_to_quat

    with open(path, "w") as f:
        for k in range(edges.m):
            q = _rot_to_quat(edges.R[k])
            t = edges.t[k]
            # isotropic info blocks: translation block tau*I3 parses back to
            # tau (3/tr((tau I)^-1) = tau); rotation block 2*kappa*I3 parses
            # back to kappa (3/(2 tr((2k I)^-1)) = 3/(2 * 3/(2k)) = k).
            it_ = edges.tau[k]
            ir = 2.0 * edges.kappa[k]
            f.write(
                f"EDGE_SE3:QUAT {edges.p1[k]} {edges.p2[k]} "
                f"{t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{it_} 0 0 0 0 0 {it_} 0 0 0 0 {it_} 0 0 0 "
                f"{ir} 0 0 {ir} 0 {ir}\n"
            )
