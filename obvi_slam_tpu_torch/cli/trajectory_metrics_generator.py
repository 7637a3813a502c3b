"""ATE/RPE/waypoint-consistency metrics — the ``trajectory_metrics_generator``
equivalent (src/evaluation/trajectory_metrics_generator.cpp:100-145). Compares
an estimated trajectory (robot_poses.csv result) to a ground-truth trajectory
after Umeyama alignment and writes the metric file (schema per
approach_metrics.py:574-615).

The port's counterpart of ``cli/trajectory_metrics_generator.py``:

    python -m obvi_slam_tpu_torch.cli.trajectory_metrics_generator \\
        --est_trajectory_file robot_poses.csv --gt_trajectory_file gt_poses.csv \\
        --metrics_out_file metrics.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_traj_csv(path):
    from obvi_slam_tpu_torch.io.readers import read_poses_by_node_id

    poses = read_poses_by_node_id(path)
    n = max(poses) + 1
    out = np.full((n, 6), np.nan)
    for node, p in poses.items():
        out[node] = p
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--est_trajectory_file", required=True)
    parser.add_argument("--gt_trajectory_file", required=True)
    parser.add_argument("--metrics_out_file", required=True)
    parser.add_argument("--waypoints_file", default="", help="JSON: waypoint_id -> [node ids]")
    parser.add_argument(
        "--ref_schema_out_file",
        default="",
        help="also write the metrics in the reference's metric-file schema "
        "(MetricsFileConstants, approach_metrics.py:574-615) so the "
        "reference's readMetricsFile/plotters consume them directly",
    )
    args = parser.parse_args(argv)

    import obvi_slam_tpu_torch.metrics as M

    est = load_traj_csv(args.est_trajectory_file)
    gt = load_traj_csv(args.gt_trajectory_file)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]

    aligned = M.align_with_ground_truth(gt, est)
    ate = M.ate_for_synced_aligned(aligned, gt)
    rpe = M.rpe_for_synced_aligned(aligned, gt)

    waypoint_deviations = {}
    all_t, all_r = [], []
    if args.waypoints_file:
        with open(args.waypoints_file) as f:
            waypoints = json.load(f)
        wp_poses = {
            int(wp): [[est[node] for node in nodes if node < len(est)]]
            for wp, nodes in waypoints.items()
        }
        waypoint_deviations, all_t, all_r = M.waypoint_consistency(wp_poses)

    out = {
        "rmse_transl_err": ate.rmse_transl_err,
        "rmse_rot_err": ate.rmse_rot_err,
        "valid_poses_used_in_score": ate.valid_poses_used_in_score,
        "lost_poses": ate.lost_poses,
        "rpe_transl_err": rpe.rmse_transl_err,
        "rpe_rot_err": rpe.rmse_rot_err,
        "waypoint_deviations": {
            str(k): {"transl": v[0], "rot": v[1]}
            for k, v in waypoint_deviations.items()
        },
        "all_translation_deviations": all_t,
        "all_rotation_deviations": all_r,
    }
    with open(args.metrics_out_file, "w") as f:
        json.dump(out, f, indent=1)
    if args.ref_schema_out_file:
        from obvi_slam_tpu_torch.metrics import schema as S

        traj = S.trajectory_metrics_to_ref_json(
            ate,
            rpe=rpe,
            waypoint_deviations=out["waypoint_deviations"],
            all_translation_deviations=all_t,
            all_rotation_deviations=all_r,
        )
        S.write_metrics_file(args.ref_schema_out_file, traj, [traj])
    print(
        f"ATE transl RMSE: {ate.rmse_transl_err:.4f} m, "
        f"rot RMSE: {np.degrees(ate.rmse_rot_err):.3f} deg "
        f"({ate.valid_poses_used_in_score} poses, {ate.lost_poses} lost)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
