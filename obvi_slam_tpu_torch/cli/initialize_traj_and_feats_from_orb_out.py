"""Initial trajectory + 3-D features from raw ORB output —
``initialize_traj_and_feats_from_orb_out`` equivalent
(src/data_preprocessing_utils/unproject_main.cpp): chains per-frame velocities
into an initial trajectory and unprojects per-feature depths (primary-camera
pixel + depth + intrinsics/extrinsics) into initial world positions, writing
the poses CSV and features/features.txt.

The port's counterpart of ``cli/initialize_traj_and_feats_from_orb_out.py``:

    python -m obvi_slam_tpu_torch.cli.initialize_traj_and_feats_from_orb_out --raw_data_path raw \\
        --calibration_path calib --processed_data_path orb_out
"""

import argparse
import os
import sys

import numpy as np
from scipy.spatial.transform import Rotation


def read_velocity_dir(path):
    """velocities/<frame>.txt: one line 'tx ty tz qx qy qz qw' = relative pose
    since previous frame (base-link frame)."""
    vels = {}
    for name in sorted(os.listdir(path)):
        if not name.endswith(".txt"):
            continue
        with open(os.path.join(path, name)) as f:
            vals = [float(v) for v in f.read().split()]
        frame = int(os.path.splitext(name)[0])
        t = np.array(vals[:3])
        w = Rotation.from_quat(vals[3:7]).as_rotvec()
        vels[frame] = np.concatenate([t, w])
    return vels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--raw_data_path", required=True, help="dir with velocities/ and depths/")
    parser.add_argument("--calibration_path", required=True, help="dir with camera_matrix.txt / extrinsics for primary cam")
    parser.add_argument("--processed_data_path", required=True, help="ORB output dir (per-frame obs files); features/ and poses are written here")
    parser.add_argument("--poses_out_file", default="")
    parser.add_argument("--primary_camera_id", type=int, default=1)
    args = parser.parse_args(argv)

    # Chain velocities into an initial trajectory.
    vel_dir = os.path.join(args.raw_data_path, "velocities")
    vels = read_velocity_dir(vel_dir)
    frames = sorted(vels)
    poses = {}
    cur_r = np.eye(3)
    cur_t = np.zeros(3)
    poses[0] = np.zeros(6)
    for i, fr in enumerate(frames):
        rel = vels[fr]
        rel_r = Rotation.from_rotvec(rel[3:6]).as_matrix()
        cur_t = cur_r @ rel[:3] + cur_t
        cur_r = cur_r @ rel_r
        poses[i + 1] = np.concatenate([cur_t, Rotation.from_matrix(cur_r).as_rotvec()])

    poses_out = args.poses_out_file or os.path.join(
        args.processed_data_path, "poses", "initial_robot_poses_by_node.txt"
    )
    os.makedirs(os.path.dirname(os.path.abspath(poses_out)), exist_ok=True)
    with open(poses_out, "w") as f:
        f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for node in sorted(poses):
            p = poses[node]
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{node},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")

    # Camera matrix for the primary camera.
    k_path = os.path.join(args.calibration_path, "camera_matrix.txt")
    with open(k_path) as f:
        vals = [float(v) for v in f.read().split() if v.strip()]
    k = np.array(vals[:9]).reshape(3, 3)
    ext_path = os.path.join(args.calibration_path, "extrinsics.txt")
    if os.path.exists(ext_path):
        with open(ext_path) as f:
            e = [float(v) for v in f.read().split()]
        ext_r = Rotation.from_quat(e[3:7]).as_matrix()
        ext_t = np.array(e[:3])
    else:
        ext_r, ext_t = np.eye(3), np.zeros(3)

    # Unproject depths: depths/<frame>.txt lines 'feature_id depth', matched
    # with the primary-camera pixel from the per-frame obs file at the
    # feature's FIRST observation.
    depth_dir = os.path.join(args.raw_data_path, "depths")
    feature_positions = {}
    k_inv = np.linalg.inv(k)
    for name in sorted(os.listdir(depth_dir)):
        if not name.endswith(".txt"):
            continue
        frame = int(os.path.splitext(name)[0])
        obs_path = os.path.join(args.processed_data_path, f"{frame:06d}.txt")
        if not os.path.exists(obs_path):
            continue
        with open(obs_path) as f:
            obs_lines = f.read().splitlines()[2:]
        pixels = {}
        for line in obs_lines:
            parts = line.split()
            if len(parts) < 4:
                continue
            feat = int(parts[0])
            i = 1
            while i + 2 <= len(parts) - 1 + 1 and i + 2 <= len(parts):
                cam = int(parts[i])
                if cam == args.primary_camera_id:
                    pixels[feat] = np.array([float(parts[i + 1]), float(parts[i + 2])])
                i += 3
        with open(os.path.join(depth_dir, name)) as f:
            for line in f.read().splitlines():
                parts = line.split()
                if len(parts) < 2:
                    continue
                feat, depth = int(parts[0]), float(parts[1])
                if feat in feature_positions or feat not in pixels or depth <= 0:
                    continue
                px = pixels[feat]
                p_cam = depth * (k_inv @ np.array([px[0], px[1], 1.0]))
                # camera -> robot -> world at this frame's pose
                pose_idx = frame
                pose = poses.get(pose_idx)
                if pose is None:
                    continue
                r_w = Rotation.from_rotvec(pose[3:6]).as_matrix()
                p_robot = ext_r @ p_cam + ext_t
                feature_positions[feat] = r_w @ p_robot + pose[:3]

    feat_dir = os.path.join(args.processed_data_path, "features")
    os.makedirs(feat_dir, exist_ok=True)
    with open(os.path.join(feat_dir, "features.txt"), "w") as f:
        f.write("feature_id,x,y,z\n")
        for feat in sorted(feature_positions):
            p = feature_positions[feat]
            f.write(f"{feat},{p[0]},{p[1]},{p[2]}\n")
    print(
        f"wrote {len(poses)} poses to {poses_out}; "
        f"{len(feature_positions)} unprojected features"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
