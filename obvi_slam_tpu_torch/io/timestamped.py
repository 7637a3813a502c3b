"""Timestamped-record CSV IO shared by the data-prep / evaluation CLIs.

Formats mirror the reference's `include/file_io/` headers:
- poses by timestamp: ``seconds,nanoseconds,tx,ty,tz,qx,qy,qz,qw``
  (`pose_3d_with_timestamp_io.h`), with the optional/"lost" variant adding a
  ``lost`` column after the nanoseconds (`readOptionalPose3dWithTimestampLine`).
- node id + timestamp: ``node_id,seconds,nanoseconds``
  (`node_id_and_timestamp_io.h`).
- timestamp + waypoint: ``seconds,nanoseconds,waypoint_id,reversed``
  (`timestamp_and_waypoint_io.h`).

Quaternion order on disk is x, y, z, w (scalar-last), matching the
reference readers which construct Eigen::Quaterniond(data[6], data[3],
data[4], data[5]).

This module is a copy of ``obvi_slam_tpu/io/timestamped.py`` (numpy and
scipy only); the port keeps its own copy and imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

Timestamp = Tuple[int, int]  # (seconds, nanoseconds)


def _ensure_dir(path: str):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)


def _rows(path: str, skip_header: bool = True) -> List[List[str]]:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if skip_header and lines:
        lines = lines[1:]
    return [[c.strip() for c in ln.split(",")] for ln in lines]


def timestamp_to_millis(ts: Timestamp) -> int:
    """timestampToMillis (base_lib/pose_utils.h semantics)."""
    return ts[0] * 1000 + ts[1] // 1_000_000


def pose7_from_transl_quat(transl, quat_xyzw) -> np.ndarray:
    """[tx ty tz rx ry rz] 6-vec (rotation-vector) from transl + quat."""
    rv = Rotation.from_quat(np.asarray(quat_xyzw, dtype=np.float64)).as_rotvec()
    return np.concatenate([np.asarray(transl, dtype=np.float64), rv])


def read_poses_with_timestamps(
    path: str,
) -> List[Tuple[Timestamp, np.ndarray]]:
    """readPose3dsWithTimestampFromFile: rows of (ts, 6-vec pose)."""
    out = []
    for r in _rows(path):
        ts = (int(r[0]), int(r[1]))
        vals = [float(v) for v in r[2:9]]
        out.append((ts, pose7_from_transl_quat(vals[0:3], vals[3:7])))
    return out


def write_poses_with_timestamps(
    path: str, entries: Sequence[Tuple[Timestamp, np.ndarray]]
):
    """writePose3dsWithTimestampToFile."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(
            "seconds,nanoseconds,transl_x,transl_y,transl_z,"
            "quat_x,quat_y,quat_z,quat_w\n"
        )
        for ts, pose in entries:
            q = Rotation.from_rotvec(np.asarray(pose[3:6])).as_quat()
            f.write(
                f"{ts[0]},{ts[1]},{pose[0]},{pose[1]},{pose[2]},"
                f"{q[0]},{q[1]},{q[2]},{q[3]}\n"
            )


def write_optional_poses_with_timestamps(
    path: str, entries: Sequence[Tuple[Timestamp, Optional[np.ndarray]]]
):
    """writeOptionalPose3dsWithTimestampToFile: lost flag column; lost rows
    carry zeros for the pose entries (pose_3d_with_timestamp_io.h)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(
            "seconds,nanoseconds,lost,transl_x,transl_y,transl_z,"
            "quat_x,quat_y,quat_z,quat_w\n"
        )
        for ts, pose in entries:
            if pose is None:
                f.write(f"{ts[0]},{ts[1]},1,0,0,0,0,0,0,0\n")
            else:
                q = Rotation.from_rotvec(np.asarray(pose[3:6])).as_quat()
                f.write(
                    f"{ts[0]},{ts[1]},0,{pose[0]},{pose[1]},{pose[2]},"
                    f"{q[0]},{q[1]},{q[2]},{q[3]}\n"
                )


def read_optional_poses_with_timestamps(
    path: str,
) -> List[Tuple[Timestamp, Optional[np.ndarray]]]:
    out = []
    for r in _rows(path):
        ts = (int(r[0]), int(r[1]))
        if int(r[2]) != 0:
            out.append((ts, None))
        else:
            vals = [float(v) for v in r[3:10]]
            out.append((ts, pose7_from_transl_quat(vals[0:3], vals[3:7])))
    return out


def read_node_ids_and_timestamps(path: str) -> List[Tuple[int, Timestamp]]:
    """node_id_and_timestamp_io.h: node_id, seconds, nanoseconds."""
    return [(int(r[0]), (int(r[1]), int(r[2]))) for r in _rows(path)]


def write_node_ids_and_timestamps(
    path: str, entries: Sequence[Tuple[int, Timestamp]]
):
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("node_id,seconds,nanoseconds\n")
        for node, ts in entries:
            f.write(f"{node},{ts[0]},{ts[1]}\n")


def read_timestamps(path: str) -> List[Timestamp]:
    """seconds,nanoseconds rows (header)."""
    return [(int(r[0]), int(r[1])) for r in _rows(path)]


def write_timestamps(path: str, stamps: Sequence[Timestamp]):
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("seconds,nanoseconds\n")
        for ts in stamps:
            f.write(f"{ts[0]},{ts[1]}\n")


def read_timestamps_and_waypoints(
    path: str,
) -> List[Tuple[Timestamp, int, bool]]:
    """timestamp_and_waypoint_io.h rows: (ts, waypoint_id, reversed)."""
    return [
        ((int(r[0]), int(r[1])), int(r[2]), int(r[3]) != 0) for r in _rows(path)
    ]


def write_timestamps_and_waypoints(
    path: str, entries: Sequence[Tuple[Timestamp, int, bool]]
):
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("seconds,nanoseconds,waypoint_id,reversed\n")
        for ts, wp, rev in entries:
            f.write(f"{ts[0]},{ts[1]},{wp},{1 if rev else 0}\n")


def read_robot_pose_results(path: str) -> Dict[int, np.ndarray]:
    """Our robot_poses result CSV (io/writers.py::write_robot_pose_results):
    node_id, tx, ty, tz, qx, qy, qz, qw → {node_id: 6-vec pose}."""
    out: Dict[int, np.ndarray] = {}
    for r in _rows(path):
        vals = [float(v) for v in r[1:8]]
        out[int(r[0])] = pose7_from_transl_quat(vals[0:3], vals[3:7])
    return out
