"""Trajectory sparsifier — ``orb_trajectory_sparsifier`` equivalent
(src/data_preprocessing_utils/orb_trajectory_sparsifier.cpp:100-150): drops
frames whose pose increment since the last kept frame is below the
translation/rotation thresholds, always keeping required frames (waypoints)
and the first/last frame; renumbers frames densely and rewrites the pose file
and per-frame feature-observation files.

The port's counterpart of ``cli/orb_trajectory_sparsifier.py``:

    python -m obvi_slam_tpu_torch.cli.orb_trajectory_sparsifier --input_poses_file poses.csv \\
        --input_feature_obs_dir orb_out --output_poses_file sparse/poses.csv \\
        --output_feature_obs_dir sparse/orb_out
"""

import argparse
import json
import os
import shutil
import sys

import numpy as np
from scipy.spatial.transform import Rotation


def get_sparsified_frames(poses, transl_thresh, rot_thresh, required):
    """old frame id -> new frame id (cpp:116-149)."""
    frames = sorted(poses)
    mapping = {frames[0]: 0}
    next_new = 1
    last_pose = poses[frames[0]]
    for fr in frames[1:]:
        p = poses[fr]
        r_last = Rotation.from_rotvec(last_pose[3:6]).as_matrix()
        r_cur = Rotation.from_rotvec(p[3:6]).as_matrix()
        rel_t = r_last.T @ (p[:3] - last_pose[:3])
        angle = np.linalg.norm(Rotation.from_matrix(r_last.T @ r_cur).as_rotvec())
        if (
            np.linalg.norm(rel_t) > transl_thresh
            or angle > rot_thresh
            or fr in required
        ):
            mapping[fr] = next_new
            next_new += 1
            last_pose = p
    if frames[-1] not in mapping:
        mapping[frames[-1]] = next_new
    return mapping


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_poses_file", required=True)
    parser.add_argument("--input_feature_obs_dir", required=True)
    parser.add_argument("--output_poses_file", required=True)
    parser.add_argument("--output_feature_obs_dir", required=True)
    parser.add_argument("--required_frames_file", default="", help="JSON list of frame ids to keep")
    parser.add_argument("--max_pose_inc_threshold_transl", type=float, default=0.2)
    parser.add_argument("--max_pose_inc_threshold_rot", type=float, default=0.1)
    args = parser.parse_args(argv)

    from obvi_slam_tpu_torch.io.readers import read_poses_by_node_id

    poses = read_poses_by_node_id(args.input_poses_file)
    required = set()
    if args.required_frames_file:
        with open(args.required_frames_file) as f:
            required = set(json.load(f))
    mapping = get_sparsified_frames(
        poses,
        args.max_pose_inc_threshold_transl,
        args.max_pose_inc_threshold_rot,
        required,
    )

    os.makedirs(os.path.dirname(os.path.abspath(args.output_poses_file)), exist_ok=True)
    with open(args.output_poses_file, "w") as f:
        f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for old, new in sorted(mapping.items(), key=lambda kv: kv[1]):
            p = poses[old]
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{new},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")

    os.makedirs(args.output_feature_obs_dir, exist_ok=True)
    kept = 0
    for name in sorted(os.listdir(args.input_feature_obs_dir)):
        src_path = os.path.join(args.input_feature_obs_dir, name)
        if name == "features":
            shutil.copytree(
                src_path,
                os.path.join(args.output_feature_obs_dir, "features"),
                dirs_exist_ok=True,
            )
            continue
        if not name.endswith(".txt") or not os.path.isfile(src_path):
            continue
        with open(src_path) as f:
            lines = f.read().splitlines()
        if not lines:
            continue
        old_frame = int(lines[0].split()[0])
        if old_frame not in mapping:
            continue
        new_frame = mapping[old_frame]
        lines[0] = str(new_frame)
        with open(
            os.path.join(args.output_feature_obs_dir, f"{new_frame:06d}.txt"), "w"
        ) as f:
            f.write("\n".join(lines) + "\n")
        kept += 1
    print(f"kept {len(mapping)}/{len(poses)} frames ({kept} obs files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
