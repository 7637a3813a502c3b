"""Comparison-approach metrics entry point — ``compute_metrics_for_approach.py`` +
``trajectory_metrics_generator.cpp`` equivalent.

Given a sequence of sessions and a comparison algorithm's per-session
timestamped trajectory estimates (ORB-SLAM3 / DROID-SLAM / OA-SLAM / ours),
produces the reference's full-sequence metric file: per-session ATE + RPE
against interpolated ground truth, cross-session waypoint consistency, and
the pooled sequence aggregate.

Semantics mirror src/evaluation/trajectory_metrics_generator.cpp:
- directory layout: ``<est_root>/<idx>_<bag>/<suffix>/trajectory.csv`` and
  ``<gt_root>/<idx>_<bag>/<suffix>/interpolated_lego_loam_poses.csv``
  (trajectory_metrics_generator.cpp:86-89,374-411);
- both trajectories are re-expressed in the base_link frame, started at the
  origin, via ``adjustTrajectoryToStartAtOriginWithExtrinsics``
  (vslam_types_math_util.h:172-192): new_i = E ∘ (origin⁻¹ ∘ pose_i) ∘ E⁻¹
  with E the sensor-frame-to-base_link extrinsic;
- per-session ATE/RPE after Umeyama alignment of timestamp-matched pose
  pairs (trajectory_metrics_generator.cpp:159-193);
- waypoint consistency: each session's pose is interpolated at its waypoint
  timestamps, deviations from the across-session mean are pooled per
  waypoint (computeWaypointConsistencyResults equivalent). When
  ``--odometry_files_directory`` provides a per-session timestamped odometry
  CSV, waypoints in lost/out-of-range regions are recovered by chaining the
  odometry delta from the nearest non-lost estimated pose — the reference's
  ``interpolate3dPosesUsingOdom``
  (trajectory_evaluation_utils.cpp:278-324,
  trajectory_interpolation_utils.cpp:443-520) pulls the same odometry from
  rosbags and solves a relpose chain whose solution outside the anchored
  range IS the chained odometry delta; without odometry, lost frames
  contribute no waypoint pose (pre-r4 behavior);
- output: the reference metric-file schema (approach_metrics.py:574-615) via
  obvi_slam_tpu_torch.metrics.schema.

Unlike the reference this does not need rosbags: ground truth is consumed as
already-interpolated timestamped CSV (use interpolate_poses_with_required_nodes
to produce it from a coarse GT trajectory). ``--traj_format tum`` accepts the
space-separated TUM files that ORB-SLAM3/DROID-SLAM write natively.

The port's counterpart of ``cli/compute_metrics_for_approach.py``:

    python -m obvi_slam_tpu_torch.cli.compute_metrics_for_approach --sequence_file seq.json \\
        --comparison_alg_traj_est_dir est --interpolated_gt_traj_dir gt \\
        --metrics_out_file metrics.json
"""

import argparse
import json
import os
import sys

import numpy as np
from scipy.spatial.transform import Rotation, Slerp

EST_TRAJ_FILE = "trajectory.csv"  # kIndivTrajectoryBaseFileName
GT_TRAJ_FILE = "interpolated_lego_loam_poses.csv"  # kGTIndivTrajectoryBaseFileName
WAYPOINT_ALIGNED_TRAJ_FILE = "traj_with_waypoints.csv"  # kWaypointAlignedTrajFileName


# ---------------------------------------------------------------------------
# Small pose helpers on 6-vec [t, rotvec] poses (numpy/scipy, host side).
# ---------------------------------------------------------------------------


def _rt(pose):
    return Rotation.from_rotvec(pose[3:6]).as_matrix(), np.asarray(pose[0:3])


def _from_rt(r, t):
    return np.concatenate([t, Rotation.from_matrix(r).as_rotvec()])


def _compose(a, b):
    ra, ta = _rt(a)
    rb, tb = _rt(b)
    return _from_rt(ra @ rb, ra @ tb + ta)


def _inverse(a):
    r, t = _rt(a)
    return _from_rt(r.T, -r.T @ t)


def adjust_to_origin_with_extrinsics(poses, origin_pose, extrinsics):
    """adjustTrajectoryToStartAtOriginWithExtrinsics
    (vslam_types_math_util.h:172-192): E ∘ (origin⁻¹ ∘ p) ∘ E⁻¹."""
    inv_origin = _inverse(origin_pose)
    inv_ext = _inverse(extrinsics)
    return [
        _compose(_compose(extrinsics, _compose(inv_origin, p)), inv_ext)
        for p in poses
    ]


# ---------------------------------------------------------------------------
# Trajectory file readers.
# ---------------------------------------------------------------------------


def read_est_trajectory(path, traj_format):
    """-> list of (ts, pose-or-None). ``timestamped`` is the reference's
    optional-pose CSV (lost flag); ``timestamped_nolost`` the plain variant;
    ``tum`` the space-separated `t tx ty tz qx qy qz qw` format that
    ORB-SLAM3 / DROID-SLAM emit."""
    from obvi_slam_tpu_torch.io import timestamped as T

    if traj_format == "tum":
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = [float(x) for x in line.replace(",", " ").split()]
                sec = int(v[0])
                nsec = int(round((v[0] - sec) * 1e9))
                out.append(
                    ((sec, nsec), T.pose7_from_transl_quat(v[1:4], v[4:8]))
                )
        return out
    if traj_format == "timestamped_nolost":
        return [(ts, p) for ts, p in T.read_poses_with_timestamps(path)]
    return T.read_optional_poses_with_timestamps(path)


def _ts_to_sec(ts):
    return ts[0] + ts[1] * 1e-9


def interpolate_pose_at(traj, t_query):
    """Linear transl + slerp rotation between the bracketing valid poses of a
    [(ts, pose-or-None)] trajectory; None outside the valid range (the
    reference extrapolates via odometry there — rosbag-only, skipped)."""
    valid = [(_ts_to_sec(ts), p) for ts, p in traj if p is not None]
    if len(valid) < 2:
        return valid[0][1] if valid else None
    times = np.array([t for t, _ in valid])
    if t_query < times[0] or t_query > times[-1]:
        return None
    hi = int(np.searchsorted(times, t_query))
    hi = min(max(hi, 1), len(times) - 1)
    lo = hi - 1
    a = (t_query - times[lo]) / max(times[hi] - times[lo], 1e-12)
    p_lo, p_hi = valid[lo][1], valid[hi][1]
    t = (1 - a) * p_lo[0:3] + a * p_hi[0:3]
    rots = Rotation.from_rotvec(np.stack([p_lo[3:6], p_hi[3:6]]))
    r = Slerp([0.0, 1.0], rots)([a])[0]
    return np.concatenate([t, r.as_rotvec()])


def in_lost_region(traj, t_query):
    """True when no non-lost pose exists within ~1.5x the trajectory's
    median valid frame spacing of ``t_query`` — the waypoint then sits in a
    lost gap (or beyond the valid range) and plain interpolation would
    bridge it blindly."""
    times = np.array([_ts_to_sec(ts) for ts, p in traj if p is not None])
    if len(times) < 2:
        return True
    max_gap = 1.5 * float(np.median(np.diff(np.sort(times))))
    return bool(np.min(np.abs(times - t_query)) > max_gap)


def _chain_from_anchor(anchor, odom_traj, t_query):
    """est(t) = est(anchor) ∘ (odom(anchor)⁻¹ ∘ odom(t)) for one anchor."""
    t_anchor, p_anchor = anchor
    o_anchor = interpolate_pose_at(odom_traj, t_anchor)
    o_query = interpolate_pose_at(odom_traj, t_query)
    if o_anchor is None or o_query is None:
        return None
    ra, ta = _rt(o_anchor)
    rq, tq = _rt(o_query)
    rel_t = ra.T @ (tq - ta)
    rel_r = ra.T @ rq
    re, te = _rt(p_anchor)
    return _from_rt(re @ rel_r, re @ rel_t + te)


def extrapolate_pose_with_odom(traj, odom, t_query):
    """Waypoint pose in a lost/out-of-range region via odometry chaining:
    est(t) = est(anchor) ∘ (odom(anchor)⁻¹ ∘ odom(t)) with anchor the
    nearest non-lost estimated pose on each side of ``t_query``.

    Matches the reference's interpolate3dPosesUsingOdom semantics
    (trajectory_interpolation_utils.cpp:443-520): its relpose-chain solve
    holds coarse (non-lost) poses fixed, so beyond the last anchor the
    optimum is exactly the one-sided anchored odometry chain, and inside an
    interior lost gap (anchors on BOTH sides) the solve blends both fixed
    endpoints — approximated here by time-weighted blending of the forward
    and backward chains (linear transl, slerp rotation). Odometry is assumed
    to be base_link-frame (trajectory_metrics_generator.cpp:124 "Assumes
    odom is for base_link"). Returns None when no anchor exists or a needed
    timestamp falls outside the odometry's span."""
    valid = [(_ts_to_sec(ts), p) for ts, p in traj if p is not None]
    if not valid or len(odom) < 2:
        return None
    odom_traj = [(ts, p) for ts, p in odom]
    before = [(t, p) for t, p in valid if t <= t_query]
    after = [(t, p) for t, p in valid if t > t_query]
    fwd = _chain_from_anchor(before[-1], odom_traj, t_query) if before else None
    bwd = _chain_from_anchor(after[0], odom_traj, t_query) if after else None
    if fwd is None and bwd is None:
        return None
    if fwd is None or bwd is None:
        return fwd if fwd is not None else bwd
    # Interior gap: blend by time proximity to each anchor.
    t_lo, t_hi = before[-1][0], after[0][0]
    a = (t_query - t_lo) / max(t_hi - t_lo, 1e-12)
    t = (1 - a) * fwd[0:3] + a * bwd[0:3]
    rots = Rotation.from_rotvec(np.stack([fwd[3:6], bwd[3:6]]))
    r = Slerp([0.0, 1.0], rots)([a])[0]
    return np.concatenate([t, r.as_rotvec()])


# ---------------------------------------------------------------------------
# The entry point.
# ---------------------------------------------------------------------------


def read_sequence(path):
    """Our sequence JSON (sequence_file_storage_io.h schema):
    -> [(bag_base_name, waypoint_file_base_name-or-None)]."""
    with open(path) as f:
        info = json.load(f)["sequence_info"]
    out = []
    for entry in info["sequence"]:
        wp = entry.get("waypoint_file_base_name", {})
        out.append(
            (
                entry["bag_base_name"],
                wp.get("v") if wp.get("has_v") else None,
            )
        )
    return out


def read_extrinsics(path):
    """readPose3dsFromFile (pose_3d_io.h): header + tx,ty,tz,qx,qy,qz,qw
    rows; first row wins (trajectory_metrics_generator.cpp:448-462)."""
    from obvi_slam_tpu_torch.io.timestamped import pose7_from_transl_quat

    with open(path) as f:
        rows = [ln.strip() for ln in f if ln.strip()][1:]
    if not rows:
        raise ValueError(f"extrinsics file {path} is empty")
    v = [float(x) for x in rows[0].split(",")]
    return pose7_from_transl_quat(v[0:3], v[3:7])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence_file", default="")
    parser.add_argument(
        "--single_trajectory_eval_base_name", default="",
        help="evaluate one session instead of a sequence",
    )
    parser.add_argument("--comparison_alg_traj_est_dir", required=True)
    parser.add_argument("--interpolated_gt_traj_dir", required=True)
    parser.add_argument("--comparison_alg_to_bl_extrinsics", default="")
    parser.add_argument(
        "--gt_frame_to_bl_extrinsics", default="",
        help="lego_loam_frame_to_bl_extrinsics equivalent",
    )
    parser.add_argument("--trajectory_results_dir_suffix", default="")
    parser.add_argument("--gt_dir_suffix", default="")
    parser.add_argument("--waypoints_files_directory", default="")
    parser.add_argument(
        "--odometry_files_directory", default="",
        help="per-session timestamped odometry CSV (<dir_name>.csv or "
        "<bag_base_name>.csv): enables waypoint extrapolation for "
        "lost frames (interpolate3dPosesUsingOdom equivalent)",
    )
    parser.add_argument("--metrics_out_file", required=True)
    parser.add_argument("--est_traj_file_name", default=EST_TRAJ_FILE)
    parser.add_argument("--gt_traj_file_name", default=GT_TRAJ_FILE)
    parser.add_argument(
        "--traj_format",
        choices=["timestamped", "timestamped_nolost", "tum"],
        default="timestamped",
    )
    args = parser.parse_args(argv)

    import obvi_slam_tpu_torch.metrics as M
    from obvi_slam_tpu_torch.io import timestamped as T
    from obvi_slam_tpu_torch.metrics import schema

    if bool(args.sequence_file) == bool(args.single_trajectory_eval_base_name):
        print(
            "Exactly one of --sequence_file and "
            "--single_trajectory_eval_base_name must be given",
            file=sys.stderr,
        )
        return 1

    if args.sequence_file:
        bags = read_sequence(args.sequence_file)
        dir_names = [f"{i}_{bag}" for i, (bag, _) in enumerate(bags)]
        waypoint_bases = [wp for _, wp in bags]
    else:
        dir_names = [args.single_trajectory_eval_base_name]
        waypoint_bases = [None]

    comparison_ext = (
        read_extrinsics(args.comparison_alg_to_bl_extrinsics)
        if args.comparison_alg_to_bl_extrinsics
        else np.zeros(6)
    )
    gt_ext = (
        read_extrinsics(args.gt_frame_to_bl_extrinsics)
        if args.gt_frame_to_bl_extrinsics
        else np.zeros(6)
    )

    # Load all sessions.
    comparison_trajs = []  # [(ts, pose-or-None)]
    gt_trajs = []  # [(ts, pose)]
    for name in dir_names:
        est_path = os.path.join(
            args.comparison_alg_traj_est_dir,
            name,
            args.trajectory_results_dir_suffix,
            args.est_traj_file_name,
        )
        gt_path = os.path.join(
            args.interpolated_gt_traj_dir,
            name,
            args.gt_dir_suffix,
            args.gt_traj_file_name,
        )
        comparison_trajs.append(
            read_est_trajectory(est_path, args.traj_format)
            if os.path.exists(est_path)
            else []
        )
        gt_trajs.append(
            T.read_poses_with_timestamps(gt_path)
            if os.path.exists(gt_path)
            else []
        )

    # The shared origin is the first valid comparison pose across the whole
    # sequence (trajectory_metrics_generator.cpp:416-441).
    first_pose = None
    for traj in comparison_trajs:
        for _, p in traj:
            if p is not None:
                first_pose = p
                break
        if first_pose is not None:
            break
    if first_pose is None:
        print("no valid comparison poses found", file=sys.stderr)
        return 1

    def adjust_optional(traj, origin, ext):
        poses = [p for _, p in traj if p is not None]
        adj = adjust_to_origin_with_extrinsics(poses, origin, ext)
        it = iter(adj)
        return [
            (ts, next(it) if p is not None else None) for ts, p in traj
        ]

    comparison_rel_bl = [
        adjust_optional(traj, first_pose, comparison_ext)
        for traj in comparison_trajs
    ]
    first_gt = None
    for traj in gt_trajs:
        if traj:
            first_gt = traj[0][1]
            break
    gt_rel_bl = [
        [
            (ts, p)
            for ts, p in adjust_optional(traj, first_gt, gt_ext)
        ]
        if traj
        else []
        for traj in gt_trajs
    ]

    # Per-session odometry (optional; lost-frame waypoint extrapolation).
    odom_trajs = []
    for idx, name in enumerate(dir_names):
        odom = []
        if args.odometry_files_directory:
            candidates = [name]
            if args.sequence_file:
                candidates.append(bags[idx][0])
            for cand in candidates:
                op = os.path.join(args.odometry_files_directory, cand)
                if not os.path.exists(op) and not cand.endswith(".csv"):
                    op += ".csv"
                if os.path.exists(op):
                    odom = T.read_poses_with_timestamps(op)
                    break
        odom_trajs.append(odom)

    # Waypoint poses per session (interpolated at waypoint timestamps).
    waypoint_poses = {}  # waypoint_id -> per-session pose lists
    for idx, (traj, wp_base) in enumerate(
        zip(comparison_rel_bl, waypoint_bases)
    ):
        annotations = []
        if wp_base and args.waypoints_files_directory:
            wp_path = os.path.join(
                args.waypoints_files_directory, wp_base
            )
            if not os.path.exists(wp_path) and not wp_base.endswith(".csv"):
                wp_path += ".csv"
            if os.path.exists(wp_path):
                for ts, wp_id, _rev in T.read_timestamps_and_waypoints(
                    wp_path
                ):
                    t_q = _ts_to_sec(ts)
                    pose = interpolate_pose_at(traj, t_q)
                    if odom_trajs[idx] and (
                        pose is None or in_lost_region(traj, t_q)
                    ):
                        ext = extrapolate_pose_with_odom(
                            traj, odom_trajs[idx], t_q
                        )
                        if ext is not None:
                            pose = ext
                    annotations.append((ts, wp_id, pose))
        for ts, wp_id, pose in annotations:
            waypoint_poses.setdefault(wp_id, [[] for _ in dir_names])
        for ts, wp_id, pose in annotations:
            if pose is not None:
                waypoint_poses[wp_id][idx].append(pose)
        # traj_with_waypoints.csv artifact per session.
        est_dir = os.path.join(
            args.comparison_alg_traj_est_dir,
            dir_names[idx],
            args.trajectory_results_dir_suffix,
        )
        if annotations and os.path.isdir(est_dir):
            T.write_optional_poses_with_timestamps(
                os.path.join(est_dir, WAYPOINT_ALIGNED_TRAJ_FILE),
                [(ts, pose) for ts, _, pose in annotations],
            )

    per_wp, _all_t, _all_r = M.waypoint_consistency(waypoint_poses)

    # Per-session split of the deviations (the reference reports each
    # session's own deviations from the across-session mean,
    # trajectory_metrics_generator.cpp:195-216).
    from obvi_slam_tpu_torch.metrics.trajectory import _mean_pose, _rt as _rt_m

    def session_waypoint_devs(session_idx):
        out = {}
        for wp_id, per_traj in waypoint_poses.items():
            all_poses = [p for traj in per_traj for p in traj if p is not None]
            if len(all_poses) < 2 or not per_traj[session_idx]:
                continue
            rm, tm = _rt_m(_mean_pose(all_poses))
            t_devs, r_devs = [], []
            for p in per_traj[session_idx]:
                r, t = _rt_m(p)
                t_devs.append(float(np.linalg.norm(t - tm)))
                r_devs.append(
                    float(
                        np.linalg.norm(
                            Rotation.from_matrix(rm.T @ r).as_rotvec()
                        )
                    )
                )
            out[wp_id] = (t_devs, r_devs)
        return out

    # Per-session ATE/RPE on timestamp-matched, aligned pose arrays.
    indiv_jsons = []
    ates, rpes = [], []
    for traj_num, (est_traj, gt_traj) in enumerate(
        zip(comparison_rel_bl, gt_rel_bl)
    ):
        gt_by_ts = {ts: p for ts, p in gt_traj}
        pairs = [
            (p, gt_by_ts[ts]) for ts, p in est_traj if ts in gt_by_ts
        ]
        est_arr = np.array(
            [p if p is not None else [np.nan] * 6 for p, _ in pairs]
        ).reshape(-1, 6)
        gt_arr = np.array([g for _, g in pairs]).reshape(-1, 6)
        if pairs and np.any(~np.all(np.isnan(est_arr), axis=1)):
            aligned = M.align_with_ground_truth(gt_arr, est_arr)
            ate = M.ate_for_synced_aligned(aligned, gt_arr)
            rpe = M.rpe_for_synced_aligned(aligned, gt_arr)
        else:
            ate = M.ate_for_synced_aligned(
                np.zeros((0, 6)), np.zeros((0, 6))
            )
            rpe = ate
        ates.append(ate)
        rpes.append(rpe)
        wp_devs = session_waypoint_devs(traj_num)
        all_t = [d for t_devs, _ in wp_devs.values() for d in t_devs]
        all_r = [d for _, r_devs in wp_devs.values() for d in r_devs]
        indiv_jsons.append(
            schema.trajectory_metrics_to_ref_json(
                ate,
                rpe,
                waypoint_deviations={
                    str(wp): {
                        "transl": list(map(float, t_devs)),
                        "rot": list(map(float, r_devs)),
                    }
                    for wp, (t_devs, r_devs) in wp_devs.items()
                },
                all_translation_deviations=all_t,
                all_rotation_deviations=all_r,
            )
        )

    seq_ate = M.combine_ate_results(ates)
    seq_rpe = M.combine_ate_results(rpes)
    seq_json = schema.trajectory_metrics_to_ref_json(
        seq_ate,
        seq_rpe,
        waypoint_deviations={
            str(wp): {
                "transl": list(map(float, t_devs)),
                "rot": list(map(float, r_devs)),
            }
            for wp, (t_devs, r_devs) in per_wp.items()
        },
        all_translation_deviations=_all_t,
        all_rotation_deviations=_all_r,
    )

    os.makedirs(
        os.path.dirname(os.path.abspath(args.metrics_out_file)), exist_ok=True
    )
    schema.write_metrics_file(args.metrics_out_file, seq_json, indiv_jsons)
    print(
        f"wrote metrics for {len(dir_names)} session(s): "
        f"rmse_transl={seq_ate.rmse_transl_err:.4f} "
        f"rmse_rot={seq_ate.rmse_rot_err:.4f} -> {args.metrics_out_file}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
