"""Result writers matching the reference's output schemas
(robot_poses_results_file / ellipsoids_results_file /
visual_feature_results_file, offline_object_visual_slam_main.cpp:1047-1106).

This module is a copy of ``obvi_slam_tpu/io/writers.py`` (numpy and scipy
only); the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch.pose_graph import PoseGraph


def _ensure_dir(path: str):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)


def write_robot_pose_results(path: str, pg: PoseGraph):
    """node_id, tx, ty, tz, qx, qy, qz, qw (pose_3d_with_node_id_io.h)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for frame in pg.frame_ids():
            p = pg.robot_poses[frame]
            q = Rotation.from_rotvec(p[3:6]).as_quat()  # [x, y, z, w]
            f.write(
                f"{frame},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n"
            )


def write_ellipsoid_results(path: str, pg: PoseGraph):
    """semantic_class, tx, ty, tz, qx, qy, qz, qw, d_x, d_y, d_z, obj_id
    (global_object_estimates_io.h ObjectEst + id at entry 11)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(
            "semantic_class,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,"
            "quat_w,d_x,d_y,d_z,obj_id\n"
        )
        for obj_id in sorted(pg.objects):
            node = pg.objects[obj_id]
            e = node.ellipsoid
            q = Rotation.from_euler("z", e[3]).as_quat()
            f.write(
                f"{node.semantic_class},{e[0]},{e[1]},{e[2]},"
                f"{q[0]},{q[1]},{q[2]},{q[3]},{e[4]},{e[5]},{e[6]},{obj_id}\n"
            )


def write_visual_feature_results(path: str, pg: PoseGraph):
    """feature_id, x, y, z (features_ests_with_id_io.h)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("feature_id,x,y,z\n")
        for feat_id in sorted(pg.features):
            p = pg.features[feat_id]
            f.write(f"{feat_id},{p[0]},{p[1]},{p[2]}\n")


def write_bb_association_results(path: str, pg: PoseGraph):
    """Bounding-box association results artifact — the
    ``--bb_associations_out_file`` output (ObjectDataAssociationResults,
    offline_object_visual_slam_main.cpp:1084-1096): the final ellipsoid
    estimates plus, per object, every associated observed bounding box
    (frame, camera, corner locations). JSON replaces cv::FileStorage
    (SURVEY.md non-goal)."""
    import json

    _ensure_dir(path)
    ellipsoids = {}
    for obj_id in sorted(pg.objects):
        node = pg.objects[obj_id]
        ellipsoids[str(obj_id)] = {
            "semantic_class": node.semantic_class,
            "ellipsoid": [float(v) for v in node.ellipsoid],
        }
    associations: Dict[str, list] = {}
    for f in pg.object_observations:
        if f is None:
            continue
        associations.setdefault(str(f.object_id), []).append(
            {
                "frame_id": int(f.frame_id),
                "camera_id": int(f.camera_id),
                "corners": [float(c) for c in f.corners],
            }
        )
    with open(path, "w") as fh:
        json.dump(
            {
                "bounding_box_associations": {
                    "ellipsoid_pose_results": ellipsoids,
                    "associated_bounding_boxes": associations,
                }
            },
            fh,
        )


def read_bb_association_results(path: str):
    """Inverse of write_bb_association_results:
    (obj_id -> (class, 7-vec), obj_id -> [(frame, cam, corners4)])."""
    import json

    with open(path) as fh:
        d = json.load(fh)["bounding_box_associations"]
    ellipsoids = {
        int(k): (v["semantic_class"], np.asarray(v["ellipsoid"]))
        for k, v in d["ellipsoid_pose_results"].items()
    }
    associations = {
        int(k): [
            (o["frame_id"], o["camera_id"], np.asarray(o["corners"]))
            for o in obs
        ]
        for k, obs in d["associated_bounding_boxes"].items()
    }
    return ellipsoids, associations


def read_ellipsoid_results(path: str) -> Dict[int, tuple]:
    """Inverse of write_ellipsoid_results: obj_id -> (class, 7-vec)."""
    out = {}
    with open(path) as f:
        lines = f.read().strip().splitlines()
    for line in lines[1:]:
        r = [e.strip() for e in line.split(",")]
        cls = r[0]
        t = [float(r[1]), float(r[2]), float(r[3])]
        quat = [float(r[4]), float(r[5]), float(r[6]), float(r[7])]
        yaw = Rotation.from_quat(quat).as_euler("zyx")[0]
        dims = [float(r[8]), float(r[9]), float(r[10])]
        obj_id = int(r[11])
        out[obj_id] = (cls, np.array(t + [yaw] + dims))
    return out
