"""Two-phase outlier selection and factor re-selection on the device.

Counterpart of ``obvi_slam_tpu/solver/two_phase.py``: after phase 1, the
worst ``feature_outlier_percentage`` of live reprojection and bounding-box
blocks (stable ranking by squared residual) are excluded, and the reference's
factor-selection cascade (minimum observations per feature, per frame and
per object; shape and LTM priors of included objects) is re-evaluated with
segment sums over the factor tables.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from obvi_slam_tpu_torch.solver.schur import FactorWeights


class TwoPhaseConfig(NamedTuple):
    """Factor-selection parameters of one window iteration."""

    feature_outlier_percentage: float = 0.1
    min_low_level_feature_observations: int = 3
    min_low_level_feature_observations_per_frame: int = 50
    min_object_observations: int = 1
    include_visual_factors: bool = True
    include_object_factors: bool = True
    include_shape_priors: bool = True
    fix_objects: bool = False
    fix_ltm_objects: bool = False
    force_include_ltm_objs: bool = False


class TwoPhaseAux(NamedTuple):
    """Per-problem arrays the re-selection needs."""

    is_ltm_obj: torch.Tensor  # (n_obj,) bool
    shape_live: torch.Tensor  # (S,) bool: shape row is not a merge tombstone


def _outlier_mask(sq, live, pct):
    """Worst-``pct`` live rows by squared residual: stable argsort of -sq
    over live rows, ranks below floor(f32(n_live) * f32(pct)) are outliers
    (the count is pinned to float32 under any working dtype, as the host
    pass computes it)."""
    neg = torch.where(live, sq, torch.full_like(sq, -float("inf")))
    order = torch.argsort(-neg, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    n_out = torch.floor(
        live.sum().to(torch.float32) * torch.tensor(pct, dtype=torch.float32)
    ).to(order.dtype)
    return live & (rank < n_out)


def _segment_count(keep, idx, n, dtype):
    return keep.new_zeros(n, dtype=dtype).index_add_(0, idx.long(), keep.to(dtype))


def reweight_on_device(
    tables, w1, res_reproj, res_bbox, aux: TwoPhaseAux, cfg: TwoPhaseConfig,
    n_pose: int, n_point: int,
):
    """Phase-2 FactorWeights from the phase-1 weights and the residuals at
    the phase-1 optimum. Ranking pools rows live under the phase-1 weights;
    candidacy restarts from every table row minus the outliers."""
    dtype = w1.reproj.dtype
    rp, bb, sh, rl, lt = tables.reproj, tables.bbox, tables.shape, tables.relpose, tables.ltm
    n_obj = aux.is_ltm_obj.shape[0]
    pct = cfg.feature_outlier_percentage

    rp_live = rp.mask & (w1.reproj > 0)
    bb_live = bb.mask & (w1.bbox > 0)
    rp_keep = rp.mask & ~_outlier_mask((res_reproj * res_reproj).sum(1), rp_live, pct)
    bb_keep = bb.mask & ~_outlier_mask((res_bbox * res_bbox).sum(1), bb_live, pct)

    feat_count = _segment_count(rp_keep, rp.point_idx, n_point, dtype)
    rp_keep = rp_keep & (
        feat_count[rp.point_idx.long()] >= cfg.min_low_level_feature_observations
    )
    if not cfg.include_visual_factors:
        rp_keep = torch.zeros_like(rp_keep)

    # Relpose factors only for feature-starved frames.
    if cfg.min_low_level_feature_observations_per_frame > 0 and cfg.include_visual_factors:
        frame_obs = _segment_count(rp_keep, rp.pose_idx, n_pose, dtype)
        starved = frame_obs < cfg.min_low_level_feature_observations_per_frame
        rl_keep = rl.mask & (starved[rl.before_idx.long()] | starved[rl.after_idx.long()])
    else:
        rl_keep = torch.zeros_like(rl.mask)

    obj_count = _segment_count(bb_keep, bb.obj_idx, n_obj, dtype)
    obj_included = (
        (obj_count >= cfg.min_object_observations) | aux.is_ltm_obj
    ) & (obj_count > 0)
    bb_keep = bb_keep & obj_included[bb.obj_idx.long()]
    if not cfg.include_object_factors:
        bb_keep = torch.zeros_like(bb_keep)
        obj_included = torch.zeros_like(obj_included)

    # Object-only factors (shape and LTM priors) for included objects.
    if cfg.include_object_factors and not cfg.fix_objects:
        if cfg.fix_objects or cfg.fix_ltm_objects:
            objs_oo = obj_included & ~aux.is_ltm_obj
        else:
            objs_oo = obj_included
            if cfg.force_include_ltm_objs:
                objs_oo = objs_oo | aux.is_ltm_obj
    else:
        objs_oo = torch.zeros_like(obj_included)
    if cfg.include_shape_priors:
        sh_keep = sh.mask & aux.shape_live & objs_oo[sh.obj_idx.long()]
    else:
        sh_keep = torch.zeros_like(sh.mask)
    lt_keep = lt.mask & objs_oo[lt.obj_idx.long()]

    return FactorWeights(
        reproj=rp_keep.to(dtype),
        bbox=bb_keep.to(dtype),
        shape=sh_keep.to(dtype),
        relpose=rl_keep.to(dtype),
        ltm=lt_keep.to(dtype),
    )
