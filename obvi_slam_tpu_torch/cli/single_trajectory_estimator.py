"""One-session estimator with preprocessing — ``single_trajectory_estimator.py``
equivalent (src/evaluation/single_trajectory_estimator.py): optionally runs
the ORB post-processing chain (unprojection + sparsification) and then the
main pipeline.

The port's counterpart of ``cli/single_trajectory_estimator.py``: each step
is the port's module of the same name in a process of its own
(``orb_stereo_reformat_data``, ``initialize_traj_and_feats_from_orb_out``,
``orb_trajectory_sparsifier``, ``offline_object_visual_slam_main``), and
``--device`` (default ``cuda``) is the main step's:

    python -m obvi_slam_tpu_torch.cli.single_trajectory_estimator \\
        --params_config_file config.json --intrinsics_file intrinsics.csv \\
        --extrinsics_file extrinsics.csv --orb_out_dir orb_out --output_dir out \\
        --sparsify [--device cpu]

It reads the initial trajectory from
``<orb_out_dir>/poses/initial_robot_poses_by_node.txt``.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

# The directory that holds the obvi_slam_tpu_torch package.
ROOT = Path(__file__).resolve().parents[2]
CLI = "obvi_slam_tpu_torch.cli."


def run(cmd):
    """``python -m <cmd[0]> <cmd[1:]>``; exits with its code when it fails."""
    print("[estimator]", " ".join(str(c) for c in cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    r = subprocess.run([sys.executable, "-m"] + [str(c) for c in cmd], env=env)
    if r.returncode != 0:
        sys.exit(r.returncode)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--intrinsics_file", required=True)
    parser.add_argument("--extrinsics_file", required=True)
    parser.add_argument("--orb_out_dir", required=True, help="reformatted ORB output")
    parser.add_argument(
        "--raw_orb_matches_dir",
        default="",
        help="raw stereo-ORB match files; when given, reformatted into "
        "--orb_out_dir first (reference runOrbPostProcess step 1, "
        "single_trajectory_estimator.py:119-176)",
    )
    parser.add_argument("--raw_data_path", default="", help="velocities/depths for unprojection")
    parser.add_argument("--calibration_path", default="")
    parser.add_argument("--bounding_boxes_by_node_id_file", default="")
    parser.add_argument("--long_term_map_input", default="")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--sparsify", action="store_true")
    parser.add_argument("--max_pose_inc_threshold_transl", type=float, default=0.2)
    parser.add_argument("--max_pose_inc_threshold_rot", type=float, default=0.1)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the main step (default cuda; cpu runs on the CPU)")
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.raw_orb_matches_dir:
        run(
            [
                CLI + "orb_stereo_reformat_data",
                "-i", args.raw_orb_matches_dir,
                "-o", args.orb_out_dir,
            ]
        )
    feats_dir = args.orb_out_dir
    poses_file = os.path.join(feats_dir, "poses", "initial_robot_poses_by_node.txt")

    # Preprocessing: unproject (if raw data given), then sparsify.
    if args.raw_data_path:
        run(
            [
                CLI + "initialize_traj_and_feats_from_orb_out",
                "--raw_data_path", args.raw_data_path,
                "--calibration_path", args.calibration_path,
                "--processed_data_path", args.orb_out_dir,
                "--poses_out_file", poses_file,
            ]
        )
    if args.sparsify:
        sparse_dir = os.path.join(args.output_dir, "sparsified_orb_out")
        sparse_poses = os.path.join(args.output_dir, "sparsified_poses.csv")
        run(
            [
                CLI + "orb_trajectory_sparsifier",
                "--input_poses_file", poses_file,
                "--input_feature_obs_dir", feats_dir,
                "--output_poses_file", sparse_poses,
                "--output_feature_obs_dir", sparse_dir,
                "--max_pose_inc_threshold_transl", args.max_pose_inc_threshold_transl,
                "--max_pose_inc_threshold_rot", args.max_pose_inc_threshold_rot,
            ]
        )
        feats_dir = sparse_dir
        poses_file = sparse_poses

    cmd = [
        CLI + "offline_object_visual_slam_main",
        "--params_config_file", args.params_config_file,
        "--intrinsics_file", args.intrinsics_file,
        "--extrinsics_file", args.extrinsics_file,
        "--poses_by_node_id_file", poses_file,
        "--low_level_feats_dir", feats_dir,
        "--long_term_map_output", os.path.join(args.output_dir, "long_term_map.json"),
        "--robot_poses_results_file", os.path.join(args.output_dir, "robot_poses.csv"),
        "--ellipsoids_results_file", os.path.join(args.output_dir, "ellipsoids.csv"),
        "--visual_feature_results_file", os.path.join(args.output_dir, "features.csv"),
        "--checkpoint_output_dir", os.path.join(args.output_dir, "checkpoints"),
        "--timing_report_file", os.path.join(args.output_dir, "timing.json"),
        "--opt_log_file", os.path.join(args.output_dir, "ceres_opt_summary.csv"),
    ]
    if args.bounding_boxes_by_node_id_file:
        cmd += ["--bounding_boxes_by_node_id_file", args.bounding_boxes_by_node_id_file]
    if args.long_term_map_input:
        cmd += ["--long_term_map_input", args.long_term_map_input]
    cmd += ["--device", args.device]
    run(cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
