"""Full-sequence metrics — ``compute_metrics_for_ut_vslam.py`` +
``approach_metrics.py`` equivalent: per-session ATE/RPE + pooled sequence
aggregate (combineSingleTrajectoryResults), cross-session waypoint
consistency, optional object metrics, and CDF plot artifacts.

The port's counterpart of ``cli/compute_metrics_for_sequence.py``:

    python -m obvi_slam_tpu_torch.cli.compute_metrics_for_sequence --sequence_results_file sessions.json \\
        --metrics_out_file metrics.json [--plots_dir plots]

``--plots_dir`` needs matplotlib.
"""

import argparse
import json
import os
import sys

import numpy as np


def load_traj(path):
    from obvi_slam_tpu_torch.io.readers import read_poses_by_node_id

    poses = read_poses_by_node_id(path)
    n = max(poses) + 1
    out = np.full((n, 6), np.nan)
    for node, p in poses.items():
        out[node] = p
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--sequence_results_file", required=True,
        help="JSON list of {name, est_trajectory_file, gt_trajectory_file, "
        "waypoints_file?, est_objects_file?, gt_objects_file?}",
    )
    parser.add_argument("--metrics_out_file", required=True)
    parser.add_argument("--plots_dir", default="")
    parser.add_argument(
        "--ref_schema_out_file",
        default="",
        help="also write the reference's full-sequence metric-file schema "
        "(readMetricsFile-compatible, approach_metrics.py:574-615) — the "
        "format compute_metrics_for_approach-style comparisons consume",
    )
    args = parser.parse_args(argv)

    import obvi_slam_tpu_torch.metrics as M

    with open(args.sequence_results_file) as f:
        sessions = json.load(f)

    per_session = []
    ate_list, rpe_list = [], []
    waypoint_poses = {}  # wp -> [per-session pose lists]
    obj_metrics = []
    for s in sessions:
        est = load_traj(s["est_trajectory_file"])
        gt = load_traj(s["gt_trajectory_file"])
        n = min(len(est), len(gt))
        est, gt = est[:n], gt[:n]
        aligned = M.align_with_ground_truth(gt, est)
        ate = M.ate_for_synced_aligned(aligned, gt)
        rpe = M.rpe_for_synced_aligned(aligned, gt)
        ate_list.append(ate)
        rpe_list.append(rpe)
        rec = {
            "name": s.get("name", ""),
            "rmse_transl_err": ate.rmse_transl_err,
            "rmse_rot_err": ate.rmse_rot_err,
            "rpe_transl_err": rpe.rmse_transl_err,
            "rpe_rot_err": rpe.rmse_rot_err,
            "valid_poses_used_in_score": ate.valid_poses_used_in_score,
            "lost_poses": ate.lost_poses,
        }
        if s.get("waypoints_file"):
            with open(s["waypoints_file"]) as f:
                wps = json.load(f)
            for wp, nodes in wps.items():
                waypoint_poses.setdefault(int(wp), []).append(
                    [est[node] for node in nodes if node < len(est) and not np.any(np.isnan(est[node]))]
                )
        if s.get("est_objects_file") and s.get("gt_objects_file"):
            from obvi_slam_tpu_torch.io.writers import read_ellipsoid_results

            m = M.object_metrics(
                read_ellipsoid_results(s["est_objects_file"]),
                read_ellipsoid_results(s["gt_objects_file"]),
            )
            rec["object_metrics"] = {
                "recall": m.recall,
                "missed_gt_objs": m.missed_gt_objs,
                "avg_iou": m.avg_iou,
                "average_pos_deviation": m.average_pos_deviation,
            }
            obj_metrics.append(m)
        per_session.append(rec)

    seq_ate = M.combine_ate_results(ate_list)
    seq_rpe = M.combine_ate_results(rpe_list)
    wp_devs, all_t, all_r = M.waypoint_consistency(waypoint_poses)

    out = {
        "indiv_trajectory_metrics": per_session,
        "sequence_metrics": {
            "rmse_transl_err": seq_ate.rmse_transl_err,
            "rmse_rot_err": seq_ate.rmse_rot_err,
            "rpe_transl_err": seq_rpe.rmse_transl_err,
            "rpe_rot_err": seq_rpe.rmse_rot_err,
            "all_translation_deviations": all_t,
            "all_rotation_deviations": all_r,
            "waypoint_deviations": {
                str(k): {"transl": v[0], "rot": v[1]} for k, v in wp_devs.items()
            },
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.metrics_out_file)), exist_ok=True)
    with open(args.metrics_out_file, "w") as f:
        json.dump(out, f, indent=1)
    if args.ref_schema_out_file:
        from obvi_slam_tpu_torch.metrics import schema as S

        indiv = [
            S.trajectory_metrics_to_ref_json(a, rpe=r)
            for a, r in zip(ate_list, rpe_list)
        ]
        seq = S.trajectory_metrics_to_ref_json(
            seq_ate,
            rpe=seq_rpe,
            waypoint_deviations=out["sequence_metrics"]["waypoint_deviations"],
            all_translation_deviations=all_t,
            all_rotation_deviations=all_r,
        )
        S.write_metrics_file(args.ref_schema_out_file, seq, indiv)
    print(
        f"sequence ATE transl RMSE {seq_ate.rmse_transl_err:.4f} m over "
        f"{len(sessions)} sessions; {len(all_t)} waypoint deviations"
    )
    if args.plots_dir:
        from obvi_slam_tpu_torch import visualization as viz

        os.makedirs(args.plots_dir, exist_ok=True)
        if all_t:
            viz.plot_waypoint_cdfs(
                os.path.join(args.plots_dir, "waypoint_cdfs.png"),
                {"ours": all_t},
                {"ours": all_r},
            )
        for s in sessions:
            est = load_traj(s["est_trajectory_file"])
            gt = load_traj(s["gt_trajectory_file"])
            viz.plot_topdown_trajectory(
                os.path.join(args.plots_dir, f"{s.get('name', 'session')}_topdown.png"),
                {"est": est, "gt": gt[: len(est)]},
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
