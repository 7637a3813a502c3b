"""OA-SLAM comparison metrics — ``compute_metrics_for_oaslam.py``
equivalent: the generic approach entry point with OA-SLAM conventions (the
reference reuses the ORB-SLAM3 camera-to-baselink extrinsics,
compute_metrics_for_oaslam.py:98-101; OA-SLAM's postprocessed outputs are
timestamped CSVs with a lost flag).

The port's counterpart of ``cli/compute_metrics_for_oaslam.py``:

    python -m obvi_slam_tpu_torch.cli.compute_metrics_for_oaslam --sequence_file seq.json \\
        --oa_slam_out_root_dir est --interpolated_gt_traj_dir gt \\
        --calibration_file_directory calib --metrics_out_file metrics.json
"""

import argparse
import os
import sys

from obvi_slam_tpu_torch.cli.compute_metrics_for_orbslam3 import (
    LEGO_LOAM_CALIB_FILE,
    ORB_SLAM3_CALIB_FILE,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument("--oa_slam_out_root_dir", required=True)
    parser.add_argument("--interpolated_gt_traj_dir", required=True)
    parser.add_argument("--calibration_file_directory", required=True)
    parser.add_argument("--waypoints_files_directory", default="")
    parser.add_argument("--metrics_out_file", required=True)
    parser.add_argument("--est_traj_file_name", default="trajectory.csv")
    parser.add_argument("--traj_format", default="timestamped")
    args = parser.parse_args(argv)

    from obvi_slam_tpu_torch.cli.compute_metrics_for_approach import main as approach_main

    return approach_main(
        [
            "--sequence_file", args.sequence_file,
            "--comparison_alg_traj_est_dir", args.oa_slam_out_root_dir,
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
