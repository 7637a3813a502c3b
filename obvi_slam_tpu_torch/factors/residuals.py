"""Batched residuals and Jacobians of the five factor families.

Counterpart of ``obvi_slam_tpu/factors/residuals.py``. The bounding-box and
relative-pose Jacobians come from ``torch.func.jacfwd`` of the per-block
function under ``torch.func.vmap`` (forward mode, as the reference); the
shape and LTM priors are linear and their Jacobians are written out.
``bbox_residuals_and_jac`` is the plain PyTorch version of kernel K2
(``ops/bbox.py``).

Whitening is baked into each residual; Huber robustification is applied by
the solver through ``huber_sqrt_weight``. Padding rows (mask False) give
exactly zero residuals and Jacobians.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from obvi_slam_tpu_torch import geometry as geo


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _masked(mask, x):
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    return torch.where(m, x, _zero(x))


def _masked_jac(mask, j, r):
    # Forward-mode AD promotes a 0-dim float32 tangent combined with a Python
    # float to float64; the Jacobian is returned in the residual's dtype.
    return _masked(mask, j.to(r.dtype))


def huber_rho(s, delta):
    """Ceres HuberLoss: s for s <= delta^2, else 2 delta sqrt(s) - delta^2."""
    d2 = delta * delta
    safe = torch.clamp(s, min=1e-30)
    return torch.where(s <= d2, s, 2.0 * delta * torch.sqrt(safe) - d2)


def huber_sqrt_weight(s, delta):
    """sqrt(rho'(s)): Ceres' exact robustification for Huber (its Triggs
    correction vanishes because rho'' <= 0 on both branches)."""
    d2 = delta * delta
    safe = torch.clamp(s, min=1e-30)
    return torch.where(s <= d2, torch.ones_like(s), torch.sqrt(delta / torch.sqrt(safe)))


# ---- reprojection: residual dim 2, blocks pose 6 / point 3 -----------------


def reproj_residuals(state, cams, f):
    cidx = f.cam_idx.long()
    proj, _ = geo.project_point_rectified(
        state.poses[f.pose_idx.long()],
        state.points[f.point_idx.long()],
        cams.cam_from_robot_r[cidx],
        cams.cam_from_robot_t[cidx],
    )
    return _masked(f.mask, f.multiplier * (proj - f.rect_obs))


# ---- bounding box: residual dim 4, blocks ellipsoid 7 / pose 6 -------------


def _bbox_single(ellipsoid, pose, cam_r, cam_t, rect_corners, sqrt_inf, invalid_error):
    corners, valid = geo.ellipsoid_corners_rectified(ellipsoid, pose, cam_r, cam_t)
    whitened = geo.bmv(sqrt_inf, corners - rect_corners)
    # An invalid projection saturates to a constant, so its Jacobian is zero.
    return torch.where(valid[..., None], whitened, torch.full_like(whitened, invalid_error))


def _bbox_gather(state, cams, f):
    cidx = f.cam_idx.long()
    return (
        state.objects[f.obj_idx.long()],
        state.poses[f.pose_idx.long()],
        cams.cam_from_robot_r[cidx],
        cams.cam_from_robot_t[cidx],
        f.rect_corners,
        f.sqrt_inf,
    )


def bbox_residuals(state, cams, f, invalid_error=1e6):
    r = _bbox_single(*_bbox_gather(state, cams, f), invalid_error)
    return _masked(f.mask, r)


def bbox_residuals_and_jac(state, cams, f, invalid_error=1e6):
    """Returns (r (B,4), J_obj (B,4,7), J_pose (B,4,6)); masked rows are 0."""

    def single(obj, pose, cam_r, cam_t, corners, sqrt_inf):
        r = _bbox_single(obj, pose, cam_r, cam_t, corners, sqrt_inf, invalid_error)
        return r, r

    jac = vmap(jacfwd(single, argnums=(0, 1), has_aux=True))
    (j_obj, j_pose), r = jac(*_bbox_gather(state, cams, f))
    return _masked(f.mask, r), _masked_jac(f.mask, j_obj, r), _masked_jac(f.mask, j_pose, r)


# ---- shape prior: residual dim 3, block ellipsoid 7 ------------------------


def shape_residuals(state, f):
    deviation = state.objects[f.obj_idx.long()][:, 4:7] - f.mean_dim
    return _masked(f.mask, geo.bmv(f.sqrt_inf, deviation))


def shape_residuals_and_jac(state, f):
    """Returns (r (S,3), J_obj (S,3,7)); d r / d dims = sqrt_inf."""
    r = shape_residuals(state, f)
    j = torch.zeros(f.sqrt_inf.shape[:1] + (3, 7), dtype=r.dtype, device=r.device)
    j[:, :, 4:7] = f.sqrt_inf
    return r, _masked(f.mask, j)


# ---- relative pose: residual dim 6, blocks pose 6 / pose 6 -----------------


def _relpose_single(pose_before, pose_after, meas_t, meas_r, sqrt_inf):
    rb, tb = geo.pose_to_rt(pose_before)
    ra, ta = geo.pose_to_rt(pose_after)
    rbi = rb.transpose(-1, -2)
    rel_r = geo.bmm(rbi, ra)
    rel_t = geo.bmv(rbi, ta - tb)
    rot_err = geo.bmm(rel_r, meas_r.transpose(-1, -2))
    unscaled = torch.cat([rel_t - meas_t, geo.log_so3(rot_err)], -1)
    return geo.bmv(sqrt_inf, unscaled)


def _relpose_gather(state, f):
    return (
        state.poses[f.before_idx.long()],
        state.poses[f.after_idx.long()],
        f.meas_t,
        f.meas_r,
        f.sqrt_inf,
    )


def relpose_residuals(state, f):
    return _masked(f.mask, _relpose_single(*_relpose_gather(state, f)))


def relpose_residuals_and_jac(state, f):
    """Returns (r (R,6), J_before (R,6,6), J_after (R,6,6))."""

    def single(pb, pa, mt, mr, si):
        r = _relpose_single(pb, pa, mt, mr, si)
        return r, r

    jac = vmap(jacfwd(single, argnums=(0, 1), has_aux=True))
    (j_before, j_after), r = jac(*_relpose_gather(state, f))
    return _masked(f.mask, r), _masked_jac(f.mask, j_before, r), _masked_jac(f.mask, j_after, r)


# ---- LTM prior: residual dim 7, block ellipsoid 7 --------------------------


def ltm_residuals(state, f):
    deviation = state.objects[f.obj_idx.long()] - f.mean
    return _masked(f.mask, geo.bmv(f.sqrt_inf, deviation))


def ltm_residuals_and_jac(state, f):
    """J = sqrt_inf (7x7)."""
    return ltm_residuals(state, f), _masked(f.mask, f.sqrt_inf)


# ---- scalar parameter prior ------------------------------------------------


def param_prior_residuals(state, f):
    """(x[param] - mean) / std, shape (Q,). Indices are clamped to the block
    tables, as the reference's gathers clamp."""
    bi, pi = f.block_idx.long(), f.param_idx.long()

    def pick(table):
        n, d = table.shape
        return table[bi.clamp(0, n - 1), pi.clamp(0, d - 1)]

    kind = f.block_kind
    val = torch.where(
        kind == 0,
        pick(state.poses),
        torch.where(kind == 1, pick(state.points), pick(state.objects)),
    )
    return _masked(f.mask, f.inv_std * (val - f.mean))


# ---- total robustified cost (Ceres: 0.5 * sum rho(||r||^2)) ----------------


def total_cost(
    state,
    cams,
    tables,
    huber_reproj=1.0,
    huber_bbox=0.5,
    huber_shape=10.0,
    huber_relpose=1.0,
    huber_ltm=1.0,
    invalid_error=1e6,
    reproj_weight=None,
    bbox_weight=None,
    shape_weight=None,
    relpose_weight=None,
    ltm_weight=None,
):
    """Robustified total cost, a 0-dim tensor. ``*_weight`` multiplies each
    block's rho (0 drops a factor without a shape change)."""

    def block_cost(r, mask, delta, weight):
        c = huber_rho((r * r).sum(-1), delta)
        c = torch.where(mask, c, _zero(c))
        if weight is not None:
            c = c * weight
        return 0.5 * c.sum()

    cost = block_cost(
        reproj_residuals(state, cams, tables.reproj), tables.reproj.mask,
        huber_reproj, reproj_weight,
    )
    cost = cost + block_cost(
        bbox_residuals(state, cams, tables.bbox, invalid_error), tables.bbox.mask,
        huber_bbox, bbox_weight,
    )
    cost = cost + block_cost(
        shape_residuals(state, tables.shape), tables.shape.mask, huber_shape,
        shape_weight,
    )
    cost = cost + block_cost(
        relpose_residuals(state, tables.relpose), tables.relpose.mask,
        huber_relpose, relpose_weight,
    )
    cost = cost + block_cost(
        ltm_residuals(state, tables.ltm), tables.ltm.mask, huber_ltm, ltm_weight
    )
    rq = param_prior_residuals(state, tables.param_prior)
    return cost + 0.5 * torch.where(tables.param_prior.mask, rq * rq, _zero(rq)).sum()


def all_residuals(state, cams, tables, invalid_error=1e6):
    """Dict of per-family whitened residuals (before Huber)."""
    return {
        "reproj": reproj_residuals(state, cams, tables.reproj),
        "bbox": bbox_residuals(state, cams, tables.bbox, invalid_error),
        "shape": shape_residuals(state, tables.shape),
        "relpose": relpose_residuals(state, tables.relpose),
        "ltm": ltm_residuals(state, tables.ltm),
        "param_prior": param_prior_residuals(state, tables.param_prior),
    }
