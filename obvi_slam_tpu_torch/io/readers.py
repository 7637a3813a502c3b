"""Readers for the reference's file formats (``include/file_io/``).

All CSVs are comma-separated with one header line
(file_io_utils.h readObjectListFromFileWithHeader). Formats:

  - intrinsics: cam_id, img_width, img_height, mat_00..mat_22 row-major
    (camera_intrinsics_with_id_io.h:33-63)
  - extrinsics: cam_id, tx, ty, tz, qx, qy, qz, qw — camera pose in robot
    frame (camera_extrinsics_with_id_io.h)
  - poses by node id: node_id, tx, ty, tz, qx, qy, qz, qw
    (pose_3d_with_node_id_io.h)
  - bounding boxes by node id: min_x, min_y, max_x, max_y, semantic_class,
    node_id, camera_id, confidence (bounding_box_by_node_id_io.h)
  - ORB output dir: per-frame ``<name>.txt`` (line 1 = frame id, line 2 = pose
    [skipped], rest = ``feat_id cam_id x y [cam_id x y ...]``) +
    ``features/features.txt`` = feature_id, x, y, z initial estimates
    (orb_output_low_level_feature_reader.cpp:140-230); features observed only
    once are dropped
  - vslam_set fixture: per-frame ``NNNNNN.txt`` = frame id line, pose line
    ``x y z qx qy qz qw``, then ``feature_id px py`` lines
    (data/vslam_set1/000001.txt)

This module is a copy of ``obvi_slam_tpu/io/readers.py`` (numpy and scipy
only, the ORB observation files parsed by the port's ``native`` runtime);
the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch import native as native_mod
from obvi_slam_tpu_torch.offline_data import RawBoundingBox
from obvi_slam_tpu_torch.pose_graph import CameraInfo


def _read_csv_rows(path: str) -> List[List[str]]:
    rows = []
    with open(path) as f:
        lines = f.read().strip().splitlines()
    for line in lines[1:]:  # skip header
        if not line.strip():
            continue
        rows.append([e.strip() for e in line.split(",")])
    return rows


def _quat_to_rotvec(qx, qy, qz, qw) -> np.ndarray:
    return Rotation.from_quat([qx, qy, qz, qw]).as_rotvec()


def read_camera_intrinsics(path: str) -> Dict[int, dict]:
    """cam_id -> {K (3,3), img_width, img_height}."""
    out = {}
    for r in _read_csv_rows(path):
        cam_id = int(r[0])
        w, h = float(r[1]), float(r[2])
        k = np.array([float(v) for v in r[3:12]]).reshape(3, 3)
        out[cam_id] = {"K": k, "img_width": w, "img_height": h}
    return out


def read_camera_extrinsics(path: str) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """cam_id -> (R, t): camera pose in robot frame."""
    out = {}
    for r in _read_csv_rows(path):
        cam_id = int(r[0])
        t = np.array([float(r[1]), float(r[2]), float(r[3])])
        rot = Rotation.from_quat(
            [float(r[4]), float(r[5]), float(r[6]), float(r[7])]
        ).as_matrix()
        out[cam_id] = (rot, t)
    return out


def make_cameras(
    intrinsics: Dict[int, dict], extrinsics: Dict[int, Tuple[np.ndarray, np.ndarray]]
) -> Tuple[Dict[int, CameraInfo], Dict[int, Tuple[float, float]]]:
    """Combine into CameraInfo map + img (height, width) map."""
    cameras = {}
    img_hw = {}
    for cam_id, info in intrinsics.items():
        if cam_id not in extrinsics:
            continue
        r, t = extrinsics[cam_id]
        cameras[cam_id] = CameraInfo(info["K"], r, t)
        img_hw[cam_id] = (info["img_height"], info["img_width"])
    return cameras, img_hw


def read_poses_by_node_id(path: str) -> Dict[int, np.ndarray]:
    """node_id -> 6-vec pose [t, axis-angle]."""
    out = {}
    for r in _read_csv_rows(path):
        node = int(r[0])
        t = [float(r[1]), float(r[2]), float(r[3])]
        w = _quat_to_rotvec(float(r[4]), float(r[5]), float(r[6]), float(r[7]))
        out[node] = np.concatenate([t, w])
    return out


def read_bounding_boxes_by_node_id(
    path: str,
) -> Dict[int, Dict[int, List[RawBoundingBox]]]:
    """frame -> cam -> [RawBoundingBox]; corners reordered to the internal
    [x_min, x_max, y_min, y_max] convention."""
    out: Dict[int, Dict[int, List[RawBoundingBox]]] = {}
    for r in _read_csv_rows(path):
        min_x, min_y, max_x, max_y = (float(v) for v in r[0:4])
        semantic_class = r[4]
        node_id = int(r[5])
        camera_id = int(r[6])
        confidence = float(r[7])
        bb = RawBoundingBox(
            np.array([min_x, max_x, min_y, max_y]), semantic_class, confidence
        )
        out.setdefault(node_id, {}).setdefault(camera_id, []).append(bb)
    return out


def read_orb_output_directory(
    directory: str,
    camera_precedence_order: Optional[List[int]] = None,
    max_frame_id: Optional[int] = None,
    native: bool = True,
):
    """Returns (feature_tracks: feat -> frame -> cam -> pixel,
    feature_init_positions: feat -> (3,)). Single-observation features are
    dropped (orb_output_low_level_feature_reader.cpp:66-71); frames past
    ``max_frame_id`` are skipped. The observation files are parsed by the
    native runtime, or in Python with ``native=False``; the results are
    equal."""
    obs: Dict[int, Dict[int, Dict[int, np.ndarray]]] = {}
    obs_count: Dict[int, int] = {}
    paths = [
        os.path.join(directory, name)
        for name in sorted(os.listdir(directory))
        if name.endswith(".txt") and os.path.isfile(os.path.join(directory, name))
    ]
    if native:
        feat_a, frame_a, cam_a, px_a, py_a = native_mod.load_orb_observations(paths)
        last = (None, None)
        for i in range(len(feat_a)):
            frame_id = int(frame_a[i])
            if max_frame_id is not None and frame_id > max_frame_id:
                continue
            feat_id = int(feat_a[i])
            obs.setdefault(feat_id, {}).setdefault(frame_id, {})[int(cam_a[i])] = (
                np.array([px_a[i], py_a[i]])
            )
            if (feat_id, frame_id) != last:
                obs_count[feat_id] = obs_count.get(feat_id, 0) + 1
                last = (feat_id, frame_id)
    else:
        for path in paths:
            with open(path) as f:
                lines = f.read().strip().splitlines()
            if len(lines) < 2:
                continue
            frame_id = int(lines[0].split()[0])
            if max_frame_id is not None and frame_id > max_frame_id:
                continue
            for line in lines[2:]:
                parts = line.split()
                if len(parts) < 4:
                    continue
                feat_id = int(parts[0])
                i = 1
                while i + 2 < len(parts):
                    cam_id = int(parts[i])
                    x, y = float(parts[i + 1]), float(parts[i + 2])
                    obs.setdefault(feat_id, {}).setdefault(frame_id, {})[cam_id] = (
                        np.array([x, y])
                    )
                    i += 3
                obs_count[feat_id] = obs_count.get(feat_id, 0) + 1
    # Drop single-observation features.
    for feat_id, n in obs_count.items():
        if n == 1:
            obs.pop(feat_id, None)

    init_positions: Dict[int, np.ndarray] = {}
    feat_file = os.path.join(directory, "features", "features.txt")
    if os.path.exists(feat_file):
        for r in _read_csv_rows(feat_file):
            init_positions[int(r[0])] = np.array(
                [float(r[1]), float(r[2]), float(r[3])]
            )
    # Keep only tracks with an initial estimate (reference requires it).
    tracks = {f: t for f, t in obs.items() if f in init_positions}
    init_positions = {f: p for f, p in init_positions.items() if f in tracks}
    return tracks, init_positions


def read_vslam_set_calibration(directory: str) -> Optional[Tuple[float, float, float, float]]:
    """(fx, fy, cx, cy) from a fixture's ``calibration/camera_matrix.txt``
    (shipped with data/vslam_set7 and every vslam_superset1 config dir:
    one line ``fx fy cx cy``), or None when absent (sets 1-6)."""
    path = os.path.join(directory, "calibration", "camera_matrix.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        vals = [float(v) for v in f.read().split()[:4]]
    return tuple(vals)


def read_vslam_set_features(directory: str) -> Dict[int, np.ndarray]:
    """Ground-truth/initial 3-D landmarks from a fixture's
    ``features/features.txt`` (space-separated ``id x y z`` lines, shipped
    with vslam_set7 / vslam_superset1)."""
    path = os.path.join(directory, "features", "features.txt")
    out: Dict[int, np.ndarray] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                out[int(parts[0])] = np.array([float(v) for v in parts[1:4]])
    return out


def read_vslam_set(
    directory: str, camera_id: int = 1
) -> Tuple[Dict[int, np.ndarray], Dict[int, Dict[int, Dict[int, np.ndarray]]]]:
    """Mini-fixture reader (data/vslam_set1...): returns
    (poses_by_frame, feature_tracks feat -> frame -> cam -> pixel)."""
    poses = {}
    tracks: Dict[int, Dict[int, Dict[int, np.ndarray]]] = {}
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".txt"):
            continue
        with open(os.path.join(directory, name)) as f:
            lines = f.read().strip().splitlines()
        if len(lines) < 2:
            continue
        frame_id = int(lines[0].split()[0])
        pose_vals = [float(v) for v in lines[1].split()]
        t = pose_vals[:3]
        w = _quat_to_rotvec(*pose_vals[3:7])
        poses[frame_id] = np.concatenate([t, w])
        for line in lines[2:]:
            parts = line.split()
            if len(parts) < 3:
                continue
            feat_id = int(parts[0])
            px = np.array([float(parts[1]), float(parts[2])])
            tracks.setdefault(feat_id, {}).setdefault(frame_id, {})[camera_id] = px
    return poses, tracks


def read_tum_consecutive_matching(directory: str, max_frames: Optional[int] = None):
    """Reader for the reference's TUM fr2_pioneer_360 consecutive-frame
    matching fixture (``data/TUM_fr2_pioneer_360_consecutive_frame_matching``):
    ``<N>_curr_<timestamp>.txt`` files with a frame-id line, a GT pose line
    ``tx ty tz qx qy qz qw`` (camera-in-world), then ``feat_id px py`` rows.
    Feature ids are ORB track ids and persist across frames.

    Returns (poses: frame -> 6-vec [t, axis-angle], tracks: feat -> frame ->
    {cam_id: pixel}, timestamps: frame -> float). Frames renumbered densely
    from 0.
    """
    import glob

    files = sorted(
        glob.glob(os.path.join(directory, "*_curr_*.txt")),
        key=lambda p: int(os.path.basename(p).split("_")[0]),
    )
    if max_frames is not None:
        files = files[:max_frames]
    poses = {}
    tracks: Dict[int, Dict[int, Dict[int, np.ndarray]]] = {}
    timestamps = {}
    for new_id, path in enumerate(files):
        base = os.path.basename(path)
        ts = float(base.split("_curr_")[1][:-4])
        with open(path) as f:
            lines = f.read().strip().splitlines()
        vals = [float(v) for v in lines[1].split()]
        w = _quat_to_rotvec(*vals[3:7])
        poses[new_id] = np.concatenate([vals[:3], w])
        timestamps[new_id] = ts
        for line in lines[2:]:
            a = line.split()
            if len(a) < 3:
                continue
            tracks.setdefault(int(a[0]), {})[new_id] = {
                1: np.array([float(a[1]), float(a[2])])
            }
    # Keep multi-observation tracks only.
    tracks = {f: t for f, t in tracks.items() if len(t) >= 2}
    return poses, tracks, timestamps
