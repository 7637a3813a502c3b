"""A session written in ObVi-SLAM's input file formats.

A frozen copy of the program's ``export_session_files``, from the raw
arrays of ``object_session.Session``: ``intrinsics.csv`` and
``extrinsics.csv`` (640 x 480 images), ``poses.csv`` (the initial
trajectory), ``gt_poses.csv``, ``bounding_boxes.csv`` and the ORB output
directory ``orb_out/`` (one file per frame: the frame id, a pose line the
reader skips, then one line per feature, ``feat_id`` followed by one ``cam_id
x y`` triple per camera that sees it; ``features/features.txt`` with the
initial 3-D positions).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

POSE_HEADER = "node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n"


def _pose_rows(poses):
    quats = Rotation.from_rotvec(poses[:, 3:6]).as_quat()
    return "".join(
        f"{i},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n"
        for i, (p, q) in enumerate(zip(poses.tolist(), quats.tolist()))
    )


def write_session(s, out_dir) -> Path:
    """Writes session ``s`` into ``out_dir``; returns it as a Path."""
    out = Path(out_dir)
    (out / "orb_out" / "features").mkdir(parents=True, exist_ok=True)
    with open(out / "intrinsics.csv", "w") as f:
        f.write("camera_id,img_width,img_height,mat_00,mat_01,mat_02,mat_10,mat_11,mat_12,"
                "mat_20,mat_21,mat_22\n")
        for cam_id, k, _, _ in s.cameras:
            f.write(f"{cam_id},640,480," + ",".join(str(v) for v in k.ravel().tolist()) + "\n")
    with open(out / "extrinsics.csv", "w") as f:
        f.write("camera_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for cam_id, _, r, t in s.cameras:
            q = Rotation.from_matrix(r).as_quat().tolist()
            t = t.tolist()
            f.write(f"{cam_id},{t[0]},{t[1]},{t[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    with open(out / "poses.csv", "w") as f:
        f.write(POSE_HEADER + _pose_rows(s.init_poses))
    with open(out / "gt_poses.csv", "w") as f:
        f.write(POSE_HEADER + _pose_rows(s.gt_poses))
    with open(out / "bounding_boxes.csv", "w") as f:
        f.write("min_pixel_x,min_pixel_y,max_pixel_x,max_pixel_y,semantic_class,node_id,"
                "camera_id,detection_confidence\n")
        for frame, cam, c in zip(s.det_frame.tolist(), s.det_cam.tolist(), s.det_px.tolist()):
            f.write(f"{c[0]},{c[2]},{c[1]},{c[3]},chair,{frame},{cam},{s.det_conf}\n")
    # One line per (frame, feature), its cameras in ascending order.
    order = np.lexsort((s.obs_cam, s.obs_feat, s.obs_frame))
    frames = s.obs_frame[order].tolist()
    feats = s.obs_feat[order].tolist()
    cams = s.obs_cam[order].tolist()
    pxs = s.obs_px[order].tolist()
    lines = {frame: [] for frame in range(len(s.init_poses))}
    for i, (frame, feat) in enumerate(zip(frames, feats)):
        part = f"{cams[i]} {pxs[i][0]} {pxs[i][1]}"
        if i and frames[i - 1] == frame and feats[i - 1] == feat:
            lines[frame][-1] += " " + part
        else:
            lines[frame].append(f"{feat} {part}")
    for frame, rows in lines.items():
        with open(out / "orb_out" / f"{frame:06d}.txt", "w") as f:
            f.write(f"{frame}\n0 0 0 0 0 0 1\n")
            f.write("".join(row + "\n" for row in rows))
    with open(out / "orb_out" / "features" / "features.txt", "w") as f:
        f.write("feature_id,x,y,z\n")
        for fid, pos in zip(s.feat_ids.tolist(), s.feat_init.tolist()):
            f.write(f"{fid},{pos[0]},{pos[1]},{pos[2]}\n")
    return out
