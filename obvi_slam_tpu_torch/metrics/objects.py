"""Object map metrics: recall, position deviation, ellipsoid IoU.

Replicates ``include/evaluation/object_evaluation_utils.h:14-72`` +
``src/evaluation/object_evaluation_utils.cpp``:

  - association: greedy nearest-center within a distance bound, optionally
    one-to-one
  - IoU: sampled volumetric intersection-over-union of the ground-truth
    ellipsoid vs the UNION of its associated estimated ellipsoids
    (grid-sample membership, cpp:465-845)
  - summary: recall, missed GT objects, objects-per-GT-object, avg/median
    position deviation and IoU

This module is a copy of ``obvi_slam_tpu/metrics/objects.py`` (numpy and
scipy only); the port keeps its own copy and imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch.metrics.trajectory import (
    MetricsDistributionStatistics,
    distribution_stats,
)


def _ellipsoid_rt(ellipsoid: np.ndarray):
    """7-vec [x,y,z,yaw,dx,dy,dz] -> (R, t, semi_axes)."""
    r = Rotation.from_euler("z", ellipsoid[3]).as_matrix()
    return r, np.asarray(ellipsoid[:3]), np.asarray(ellipsoid[4:7]) / 2.0


def ellipsoid_aabb(ellipsoid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned bounding box of a rotated ellipsoid: half-extent along
    axis i = sqrt(sum_j (R_ij * a_j)^2)."""
    r, t, semi = _ellipsoid_rt(ellipsoid)
    half = np.sqrt(np.sum((r * semi[None, :]) ** 2, axis=1))
    return t - half, t + half


def _points_in_ellipsoid(points: np.ndarray, ellipsoid: np.ndarray) -> np.ndarray:
    r, t, semi = _ellipsoid_rt(ellipsoid)
    local = (points - t) @ r  # = R^T (p - t), row-wise
    semi = np.maximum(semi, 1e-12)
    return np.sum((local / semi) ** 2, axis=1) <= 1.0


def iou_for_object_set(
    gt_ellipsoid: np.ndarray,
    est_ellipsoids: List[np.ndarray],
    samples_per_dim: int = 30,
) -> float:
    """Volumetric IoU of gt vs union of est, by grid sampling the union AABB."""
    if not est_ellipsoids:
        return 0.0
    lo, hi = ellipsoid_aabb(gt_ellipsoid)
    for e in est_ellipsoids:
        elo, ehi = ellipsoid_aabb(e)
        lo = np.minimum(lo, elo)
        hi = np.maximum(hi, ehi)
    axes = [np.linspace(lo[d], hi[d], samples_per_dim) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    in_gt = _points_in_ellipsoid(pts, gt_ellipsoid)
    in_est = np.zeros(len(pts), dtype=bool)
    for e in est_ellipsoids:
        in_est |= _points_in_ellipsoid(pts, e)
    either = np.count_nonzero(in_gt | in_est)
    if either == 0:
        return 0.0
    return float(np.count_nonzero(in_gt & in_est)) / either


def associate_objects(
    estimated: Dict[int, Tuple[str, np.ndarray]],
    gt: Dict[int, Tuple[str, np.ndarray]],
    one_to_one: bool,
    max_assoc_dist: float = np.inf,
) -> Dict[int, Optional[int]]:
    """Greedy nearest-center association within class and distance bound.
    Returns est_id -> gt_id or None."""
    pairs = []
    for est_id, (est_cls, est_e) in estimated.items():
        for gt_id, (gt_cls, gt_e) in gt.items():
            if est_cls != gt_cls:
                continue
            d = float(np.linalg.norm(np.asarray(est_e[:3]) - np.asarray(gt_e[:3])))
            if d <= max_assoc_dist:
                pairs.append((d, est_id, gt_id))
    pairs.sort()
    result: Dict[int, Optional[int]] = {e: None for e in estimated}
    used_gt = set()
    assigned_est = set()
    for d, est_id, gt_id in pairs:
        if est_id in assigned_est:
            continue
        if one_to_one and gt_id in used_gt:
            continue
        result[est_id] = gt_id
        assigned_est.add(est_id)
        used_gt.add(gt_id)
    return result


@dataclass
class SingleTrajectoryObjectMetrics:
    gt_obj_for_est_obj: Dict[int, Optional[int]] = field(default_factory=dict)
    iou_for_gt_obj: Dict[int, float] = field(default_factory=dict)
    pos_diff_for_est_obj: Dict[int, Optional[float]] = field(default_factory=dict)
    recall: float = 0.0
    num_gt_objs: int = 0
    missed_gt_objs: int = 0
    objects_per_gt_obj: float = 0.0
    average_pos_deviation: float = 0.0
    avg_iou: float = 0.0
    median_pos_deviation: float = 0.0
    median_iou: float = 0.0
    pos_dev_stats: MetricsDistributionStatistics = field(
        default_factory=MetricsDistributionStatistics
    )
    iou_stats: MetricsDistributionStatistics = field(
        default_factory=MetricsDistributionStatistics
    )


def object_metrics(
    estimated: Dict[int, Tuple[str, np.ndarray]],
    gt: Dict[int, Tuple[str, np.ndarray]],
    max_assoc_dist: float = 4.0,
    samples_per_dim: int = 30,
) -> SingleTrajectoryObjectMetrics:
    m = SingleTrajectoryObjectMetrics()
    m.num_gt_objs = len(gt)
    m.gt_obj_for_est_obj = associate_objects(
        estimated, gt, one_to_one=False, max_assoc_dist=max_assoc_dist
    )

    est_by_gt: Dict[int, List[int]] = {}
    for est_id, gt_id in m.gt_obj_for_est_obj.items():
        if gt_id is not None:
            est_by_gt.setdefault(gt_id, []).append(est_id)

    pos_devs = []
    for est_id, gt_id in m.gt_obj_for_est_obj.items():
        if gt_id is None:
            m.pos_diff_for_est_obj[est_id] = None
            continue
        d = float(
            np.linalg.norm(
                np.asarray(estimated[est_id][1][:3]) - np.asarray(gt[gt_id][1][:3])
            )
        )
        m.pos_diff_for_est_obj[est_id] = d
        pos_devs.append(d)

    ious = []
    for gt_id, (gt_cls, gt_e) in gt.items():
        ests = [estimated[e][1] for e in est_by_gt.get(gt_id, [])]
        iou = iou_for_object_set(gt_e, ests, samples_per_dim)
        m.iou_for_gt_obj[gt_id] = iou
        ious.append(iou)

    found = len(est_by_gt)
    m.missed_gt_objs = m.num_gt_objs - found
    m.recall = found / m.num_gt_objs if m.num_gt_objs else 0.0
    matched_est = sum(len(v) for v in est_by_gt.values())
    m.objects_per_gt_obj = matched_est / m.num_gt_objs if m.num_gt_objs else 0.0
    m.pos_dev_stats = distribution_stats(pos_devs)
    m.iou_stats = distribution_stats(ious)
    m.average_pos_deviation = m.pos_dev_stats.average
    m.median_pos_deviation = m.pos_dev_stats.median
    m.avg_iou = m.iou_stats.average
    m.median_iou = m.iou_stats.median
    return m
