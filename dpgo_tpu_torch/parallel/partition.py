"""Graph partitioning of a global pose graph into robots/agents.

The counterpart of dpgo_tpu/parallel/partition.py (host code, the same
lists): the contiguous-block partition of the reference's multi-robot
simulation (reference: examples/MultiRobotExample.cpp:71-119). Pose k
belongs to robot k // (n // N) (the last robot takes the remainder), global
indices are re-labelled to (robot_id, local_frame_id), and each measurement
becomes odometry / private LC / shared LC of the owning robot(s).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from dpgo_tpu_torch.measurements import RelativeSEMeasurement
from dpgo_tpu_torch.types import PoseID


def contiguous_partition(num_poses: int, num_robots: int) -> List[Tuple[int, int]]:
    """[start, end) global index ranges per robot."""
    per = num_poses // num_robots
    if per <= 0:
        raise ValueError("more robots than poses")
    ranges = []
    for rid in range(num_robots):
        start = rid * per
        end = (rid + 1) * per if rid < num_robots - 1 else num_poses
        ranges.append((start, end))
    return ranges


def partition_measurements(
    measurements: Sequence[RelativeSEMeasurement],
    num_poses: int,
    num_robots: int,
) -> Tuple[
    List[List[RelativeSEMeasurement]],
    List[List[RelativeSEMeasurement]],
    List[List[RelativeSEMeasurement]],
    List[Tuple[int, int]],
]:
    """Split a single-robot dataset into per-robot
    (odometry, private_lcs, shared_lcs) with re-labelled IDs. Returns the
    three lists plus the global index ranges."""
    ranges = contiguous_partition(num_poses, num_robots)
    pose_map: Dict[int, PoseID] = {}
    for rid, (start, end) in enumerate(ranges):
        for idx in range(start, end):
            pose_map[idx] = PoseID(rid, idx - start)

    odometry: List[List[RelativeSEMeasurement]] = [[] for _ in range(num_robots)]
    private_lcs: List[List[RelativeSEMeasurement]] = [[] for _ in range(num_robots)]
    shared_lcs: List[List[RelativeSEMeasurement]] = [[] for _ in range(num_robots)]

    for m_in in measurements:
        src = pose_map[m_in.p1]
        dst = pose_map[m_in.p2]
        m = RelativeSEMeasurement(
            src.robot_id, dst.robot_id, src.frame_id, dst.frame_id,
            m_in.R, m_in.t, m_in.kappa, m_in.tau,
            m_in.weight, m_in.fixed_weight,
        )
        if src.robot_id == dst.robot_id:
            if src.frame_id + 1 == dst.frame_id:
                odometry[src.robot_id].append(m)
            else:
                private_lcs[src.robot_id].append(m)
        else:
            shared_lcs[src.robot_id].append(m)
            shared_lcs[dst.robot_id].append(m.copy())
    return odometry, private_lcs, shared_lcs, ranges
