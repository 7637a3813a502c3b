"""ORB-SLAM3 comparison metrics — ``compute_metrics_for_orbslam3.py``
equivalent: the generic approach entry point with the ORB-SLAM3 conventions
pre-applied (extrinsics file ``orb_slam3_bl.txt`` from the calibration
directory, TUM-format trajectory files, no extra result subdirs;
reference: src/evaluation/compute_metrics_for_orbslam3.py:35-51,96-105).

The port's counterpart of ``cli/compute_metrics_for_orbslam3.py``:

    python -m obvi_slam_tpu_torch.cli.compute_metrics_for_orbslam3 --sequence_file seq.json \\
        --orb_slam_3_out_root_dir est --interpolated_gt_traj_dir gt \\
        --calibration_file_directory calib --metrics_out_file metrics.json
"""

import argparse
import os
import sys

ORB_SLAM3_CALIB_FILE = "orb_slam3_bl.txt"  # CalibrationFileConstants
LEGO_LOAM_CALIB_FILE = "lego_loam_bl.txt"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument(
        "--orb_slam_3_out_root_dir", required=True,
        help="root of per-session ORB-SLAM3 trajectory outputs",
    )
    parser.add_argument("--interpolated_gt_traj_dir", required=True)
    parser.add_argument("--calibration_file_directory", required=True)
    parser.add_argument("--waypoints_files_directory", default="")
    parser.add_argument("--metrics_out_file", required=True)
    parser.add_argument("--est_traj_file_name", default="trajectory.csv")
    parser.add_argument("--traj_format", default="tum")
    args = parser.parse_args(argv)

    from obvi_slam_tpu_torch.cli.compute_metrics_for_approach import main as approach_main

    return approach_main(
        [
            "--sequence_file", args.sequence_file,
            "--comparison_alg_traj_est_dir", args.orb_slam_3_out_root_dir,
            "--interpolated_gt_traj_dir", args.interpolated_gt_traj_dir,
            "--comparison_alg_to_bl_extrinsics",
            os.path.join(args.calibration_file_directory, ORB_SLAM3_CALIB_FILE),
            "--gt_frame_to_bl_extrinsics",
            os.path.join(args.calibration_file_directory, LEGO_LOAM_CALIB_FILE),
            "--waypoints_files_directory", args.waypoints_files_directory,
            "--metrics_out_file", args.metrics_out_file,
            "--est_traj_file_name", args.est_traj_file_name,
            "--traj_format", args.traj_format,
        ]
    )


if __name__ == "__main__":
    sys.exit(main())
