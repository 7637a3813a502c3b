"""Trajectory metrics: ATE, RPE, waypoint consistency.

Definitions replicated from the reference evaluation stack
(``src/evaluation/trajectory_evaluation_utils.cpp``,
``include/evaluation/trajectory_metrics.h``, metric-file schema in
``src/evaluation/approach_metrics.py:574-615``):

  - alignment: Umeyama without scale (Zhang & Scaramuzza alg. 1, scale=1)
    over non-lost poses (trajectory_evaluation_utils.cpp:53-122)
  - ATE: per-pose ||t_gt - t_est|| and |angle(R_est^-1 R_gt)| after
    alignment; RMSE over valid poses (:145-187)
  - RPE: consecutive-pose relative error (:188-230)
  - waypoint consistency: deviation of repeated-waypoint poses from their
    across-visits mean (:getMeanPose / getDeviationFromMeanPose)

Trajectories are (N, 6) raw poses [t, axis-angle]; lost poses are NaN rows or
None entries.

This module is a copy of ``obvi_slam_tpu/metrics/trajectory.py`` (numpy and
scipy only); the port keeps its own copy and imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


@dataclass
class MetricsDistributionStatistics:
    num_vals: int = 0
    rmse: float = 0.0
    average: float = 0.0
    std_dev: float = 0.0
    median: float = 0.0
    min: float = 0.0
    max: float = 0.0
    lower_quartile: float = 0.0
    upper_quartile: float = 0.0
    # Reference-schema extras (approach_metrics.py:604-614): std-dev of the
    # squared errors and the raw error values themselves.
    squared_err_std_dev: float = 0.0
    errors: list = None


@dataclass
class ATEResults:
    rmse_transl_err: float
    rmse_rot_err: float
    transl_stats: MetricsDistributionStatistics
    rot_stats: MetricsDistributionStatistics
    valid_poses_used_in_score: int
    lost_poses: int


def distribution_stats(vals) -> MetricsDistributionStatistics:
    vals = np.asarray(vals, dtype=np.float64)
    if len(vals) == 0:
        return MetricsDistributionStatistics()
    return MetricsDistributionStatistics(
        num_vals=len(vals),
        rmse=float(np.sqrt(np.mean(vals**2))),
        average=float(np.mean(vals)),
        std_dev=float(np.std(vals)),
        median=float(np.median(vals)),
        min=float(np.min(vals)),
        max=float(np.max(vals)),
        lower_quartile=float(np.percentile(vals, 25)),
        upper_quartile=float(np.percentile(vals, 75)),
        squared_err_std_dev=float(np.std(vals**2)),
        errors=[float(v) for v in vals],
    )


def _valid_mask(est_traj: np.ndarray) -> np.ndarray:
    return ~np.any(np.isnan(est_traj), axis=1)


def _rt(pose):
    return Rotation.from_rotvec(np.asarray(pose[3:6])).as_matrix(), np.asarray(
        pose[:3]
    )


def find_alignment_transformation(
    est_traj: np.ndarray, gt_traj: np.ndarray, adjust_translation: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Umeyama alignment (scale=1): returns (R, t) mapping est -> gt frame."""
    valid = _valid_mask(est_traj)
    est = est_traj[valid, :3]
    gt = gt_traj[valid, :3]
    if adjust_translation:
        mean_est = est.mean(axis=0)
        mean_gt = gt.mean(axis=0)
    else:
        mean_est = np.zeros(3)
        mean_gt = np.zeros(3)
    cov = (gt - mean_gt).T @ (est - mean_est) / len(est)
    # Reference accumulates gt_dev * est_dev^T then SVD (cpp:85-115).
    u, _, vt = np.linalg.svd(cov)
    w = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt.T) < 0:
        w[2, 2] = -1
    rot = u @ w @ vt
    transl = mean_gt - rot @ mean_est if adjust_translation else np.zeros(3)
    return rot, transl


def align_with_ground_truth(
    gt_traj: np.ndarray, est_traj: np.ndarray, adjust_translation: bool = True
) -> np.ndarray:
    rot, transl = find_alignment_transformation(est_traj, gt_traj, adjust_translation)
    out = np.full_like(est_traj, np.nan)
    for i in range(len(est_traj)):
        if np.any(np.isnan(est_traj[i])):
            continue
        r, t = _rt(est_traj[i])
        new_r = rot @ r
        new_t = rot @ t + transl
        out[i, :3] = new_t
        out[i, 3:] = Rotation.from_matrix(new_r).as_rotvec()
    return out


def ate_for_synced_aligned(est_traj: np.ndarray, gt_traj: np.ndarray) -> ATEResults:
    transl_errs, rot_errs = [], []
    valid = 0
    for i in range(len(gt_traj)):
        if np.any(np.isnan(est_traj[i])):
            continue
        re, te = _rt(est_traj[i])
        rg, tg = _rt(gt_traj[i])
        # pose_separation = est^-1 * gt
        sep_t = re.T @ (tg - te)
        sep_r = re.T @ rg
        transl_errs.append(np.linalg.norm(sep_t))
        rot_errs.append(np.linalg.norm(Rotation.from_matrix(sep_r).as_rotvec()))
        valid += 1
    ts = distribution_stats(transl_errs)
    rs = distribution_stats(rot_errs)
    return ATEResults(ts.rmse, rs.rmse, ts, rs, valid, len(gt_traj) - valid)


def rpe_for_synced_aligned(est_traj: np.ndarray, gt_traj: np.ndarray) -> ATEResults:
    transl_errs, rot_errs = [], []
    valid = 0
    for i in range(len(gt_traj) - 1):
        if np.any(np.isnan(est_traj[i])) or np.any(np.isnan(est_traj[i + 1])):
            continue
        re0, te0 = _rt(est_traj[i])
        re1, te1 = _rt(est_traj[i + 1])
        rg0, tg0 = _rt(gt_traj[i])
        rg1, tg1 = _rt(gt_traj[i + 1])
        # est separation: pose i rel pose i+1; gt likewise; error = rel of rel.
        es_r = re1.T @ re0
        es_t = re1.T @ (te0 - te1)
        gs_r = rg1.T @ rg0
        gs_t = rg1.T @ (tg0 - tg1)
        err_r = es_r.T @ gs_r
        err_t = es_r.T @ (gs_t - es_t)
        transl_errs.append(np.linalg.norm(err_t))
        rot_errs.append(np.linalg.norm(Rotation.from_matrix(err_r).as_rotvec()))
        valid += 1
    ts = distribution_stats(transl_errs)
    rs = distribution_stats(rot_errs)
    return ATEResults(ts.rmse, rs.rmse, ts, rs, valid, len(gt_traj) - 1 - valid)


def combine_ate_results(results: List[ATEResults]) -> ATEResults:
    """combineSingleTrajectoryResults: RMSE over the pooled squared errors."""
    total_sq_t = 0.0
    total_sq_r = 0.0
    total_n = 0
    total_lost = 0
    for r in results:
        total_sq_t += (r.rmse_transl_err**2) * r.valid_poses_used_in_score
        total_sq_r += (r.rmse_rot_err**2) * r.valid_poses_used_in_score
        total_n += r.valid_poses_used_in_score
        total_lost += r.lost_poses
    if total_n == 0:
        return ATEResults(0, 0, MetricsDistributionStatistics(), MetricsDistributionStatistics(), 0, total_lost)
    return ATEResults(
        float(np.sqrt(total_sq_t / total_n)),
        float(np.sqrt(total_sq_r / total_n)),
        MetricsDistributionStatistics(),
        MetricsDistributionStatistics(),
        total_n,
        total_lost,
    )


def _mean_pose(poses: List[np.ndarray]) -> np.ndarray:
    """getMeanPose: mean translation + quaternion averaging (chordal)."""
    ts = np.mean([p[:3] for p in poses], axis=0)
    quats = np.stack(
        [Rotation.from_rotvec(p[3:6]).as_quat() for p in poses]
    )
    # Sign-align then average.
    ref = quats[0]
    for i in range(1, len(quats)):
        if np.dot(quats[i], ref) < 0:
            quats[i] = -quats[i]
    mean_q = quats.mean(axis=0)
    mean_q /= np.linalg.norm(mean_q)
    return np.concatenate([ts, Rotation.from_quat(mean_q).as_rotvec()])


def waypoint_consistency(
    waypoint_poses_by_trajectory: Dict[int, List[List[np.ndarray]]],
) -> Tuple[Dict[int, Tuple[List[float], List[float]]], List[float], List[float]]:
    """Deviations of each waypoint visit from the across-visits mean pose.

    ``waypoint_poses_by_trajectory``: waypoint_id -> per-trajectory list of
    estimated poses at that waypoint. Returns (per-waypoint (transl_devs,
    rot_devs), all_transl_devs, all_rot_devs)."""
    per_waypoint = {}
    all_t, all_r = [], []
    for wp_id, per_traj in waypoint_poses_by_trajectory.items():
        poses = [p for traj in per_traj for p in traj if p is not None]
        if len(poses) < 2:
            continue
        mean = _mean_pose(poses)
        rm, tm = _rt(mean)
        t_devs, r_devs = [], []
        for p in poses:
            r, t = _rt(p)
            t_devs.append(float(np.linalg.norm(t - tm)))
            r_devs.append(
                float(
                    np.linalg.norm(
                        Rotation.from_matrix(rm.T @ r).as_rotvec()
                    )
                )
            )
        per_waypoint[wp_id] = (t_devs, r_devs)
        all_t.extend(t_devs)
        all_r.extend(r_devs)
    return per_waypoint, all_t, all_r
