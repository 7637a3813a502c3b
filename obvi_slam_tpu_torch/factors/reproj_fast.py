"""Reprojection residual + Jacobian by per-pose tables and the chain rule.

Counterpart of ``obvi_slam_tpu/factors/reproj_fast.py``; this is the plain
PyTorch version of kernel K1 (``ops/reproj.py``):

    p_r  = R^T (x - t)            p_c = C_r p_r + C_t
    r    = mult * (p_c.xy / p_c.z - obs)
    dp_c/dx = C_r R^T,  dp_c/dt = -C_r R^T,  dp_c/dw = C_r [p_r]x Jr(w)
"""

from __future__ import annotations

import torch

from obvi_slam_tpu_torch import geometry as geo


def pose_rotation_tables(poses):
    """Per-pose R^T (world -> robot) and right Jacobian Jr(w): (P, 3, 3) each.

    The rotation derivative enters through d(R(w)^T v)/dw = [R^T v]x Jr(w)."""
    w = poses[:, 3:6]
    return geo.exp_so3(w).transpose(-1, -2), geo.right_jacobian_so3(w)


def reproj_residuals_and_jac_fast(state, cams, f):
    """Returns (r (F,2), J_pose (F,2,6), J_point (F,2,3)); masked rows are 0."""
    rt, jr = pose_rotation_tables(state.poses)
    pidx = f.pose_idx.long()
    pose_t = state.poses[pidx, 0:3]
    rt_f = rt[pidx]
    jr_f = jr[pidx]
    x = state.points[f.point_idx.long()]
    cidx = f.cam_idx.long()
    c_r = cams.cam_from_robot_r[cidx]
    c_t = cams.cam_from_robot_t[cidx]

    p_r = geo.bmv(rt_f, x - pose_t)
    p_c = geo.bmv(c_r, p_r) + c_t
    z = p_c[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-300, torch.full_like(z, 1e-300), z)
    inv_z = 1.0 / z_safe
    r = f.multiplier * (p_c[:, :2] * inv_z[:, None] - f.rect_obs)

    zero = torch.zeros_like(inv_z)
    dproj = torch.stack(
        [
            torch.stack([inv_z, zero, -p_c[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, inv_z, -p_c[:, 1] * inv_z * inv_z], -1),
        ],
        -2,
    ) * f.multiplier[:, :, None]
    j_point = geo.bmm(dproj, geo.bmm(c_r, rt_f))
    j_w = geo.bmm(dproj, geo.bmm(geo.bmm(c_r, geo.skew(p_r)), jr_f))
    j_pose = torch.cat([-j_point, j_w], -1)

    m = f.mask
    zf = torch.zeros((), dtype=r.dtype, device=r.device)
    return (
        torch.where(m[:, None], r, zf),
        torch.where(m[:, None, None], j_pose, zf),
        torch.where(m[:, None, None], j_point, zf),
    )
