"""Batched SO(3)/SE(3) and dual-quadric ellipsoid geometry in torch.

Counterpart of ``obvi_slam_tpu/geometry.py``, same conventions:
  - a raw pose is ``[tx, ty, tz, wx, wy, wz]`` (translation, axis-angle);
  - a raw ellipsoid is ``[x, y, z, yaw, dx, dy, dz]`` (yaw-only orientation);
  - rectified pixels are ``(p - c) / f``.

Every function broadcasts over leading batch dimensions. The small-angle
singularities take Taylor branches through ``torch.where`` with a safe
denominator on the unused side, so values and forward-mode derivatives
(``torch.func.jacfwd``) stay finite.
"""

from __future__ import annotations

import torch

# Squared-angle guard, as kSmallAngleThreshold in the reference.
SMALL_ANGLE = 1e-8
DIM_REGULARIZATION = 1e-3


def _sq_norm(v):
    return (v * v).sum(-1)


def bmv(m, v):
    """Batched matrix @ vector as broadcast-multiply-reduce."""
    return (m * v[..., None, :]).sum(-1)


def bmm(a, b):
    """Batched (…, i, k) @ (…, k, j) as broadcast-multiply-reduce."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def skew(w):
    """Skew-symmetric matrix of a 3-vector; batched."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def _eye_like(s):
    return torch.eye(3, dtype=s.dtype, device=s.device).expand(s.shape)


def exp_so3(w):
    """so(3) -> SO(3) via Rodrigues with a Taylor small-angle branch."""
    theta2 = _sq_norm(w)
    small = theta2 < SMALL_ANGLE**2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    s = skew(w)
    return _eye_like(s) + a[..., None, None] * s + b[..., None, None] * bmm(s, s)


def right_jacobian_so3(w):
    """Jr(w) = I - (1-cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2, Taylor-safe."""
    theta2 = _sq_norm(w)
    small = theta2 < SMALL_ANGLE**2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2_safe * theta),
    )
    s = skew(w)
    return _eye_like(s) - a[..., None, None] * s + b[..., None, None] * bmm(s, s)


def quat_from_matrix(r):
    """Rotation matrix -> unit quaternion [w, x, y, z] with w >= 0; the best
    of the four Shepperd pivots is selected per batch element."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c):
        return torch.stack([t, a, b, c], -1)

    qw = cand(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    qx = cand(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy = cand(m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    qz = cand(m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
        -1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], -2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    norm2 = torch.clamp(_sq_norm(q), min=1e-30)
    q = q / torch.sqrt(norm2)[..., None]
    sign = torch.where(q[..., 0] < 0, -torch.ones_like(q[..., 0]), torch.ones_like(q[..., 0]))
    return q * sign[..., None]


def _quat_vec_log(q):
    """log of a unit quaternion with w >= 0 -> axis * angle / 2."""
    w = q[..., 0]
    v = q[..., 1:]
    vn2 = _sq_norm(v)
    small = vn2 < SMALL_ANGLE**2
    vn2_safe = torch.where(small, torch.ones_like(vn2), vn2)
    vn = torch.sqrt(vn2_safe)
    wc = torch.clamp(w, min=0.5)
    half_angle_over_vn = torch.where(
        small, (1.0 - vn2 / (3.0 * wc**2)) / wc, torch.atan2(vn, w) / vn
    )
    return v * half_angle_over_vn[..., None]


def log_so3(r):
    """SO(3) -> so(3) through the quaternion (the reference's recommended
    AngleAxis path)."""
    return 2.0 * _quat_vec_log(quat_from_matrix(r))


def pose_to_rt(pose):
    """6-vec pose -> (R, t), world-from-body."""
    return exp_so3(pose[..., 3:6]), pose[..., 0:3]


def pose_from_rt(r, t):
    return torch.cat([t, log_so3(r)], -1)


def pose_inverse_rt(pose):
    """6-vec pose -> (R, t) of the inverse transform [R^T | -R^T t]."""
    r, t = pose_to_rt(pose)
    r_inv = r.transpose(-1, -2)
    return r_inv, -bmv(r_inv, t)


def transform_point(r, t, p):
    return bmv(r, p) + t


def compose_rt(r1, t1, r2, t2):
    """(R1, t1) o (R2, t2): apply 2 first, then 1."""
    return bmm(r1, r2), transform_point(r1, t1, t2)


def pose_compose(pose1, pose2):
    r1, t1 = pose_to_rt(pose1)
    r2, t2 = pose_to_rt(pose2)
    return pose_from_rt(*compose_rt(r1, t1, r2, t2))


def pose_between(pose1, pose2):
    """T1^-1 * T2."""
    r1i, t1i = pose_inverse_rt(pose1)
    r2, t2 = pose_to_rt(pose2)
    return pose_from_rt(*compose_rt(r1i, t1i, r2, t2))


def pose_inverse(pose):
    return pose_from_rt(*pose_inverse_rt(pose))


def essential_matrix(pose1, pose2, cam1_r, cam1_t, cam2_r, cam2_t):
    """Essential matrix relating rectified pixels of the camera at pose1 and
    pose2 (``CalcEssentialMatrix``, vslam_math_util.h:174):
    T_c1_c2 = (T_r_c1)^-1 T_w_r1^-1 T_w_r2 T_r_c2; E = [t]_x R. ``cam*_r/t``
    are the extrinsics (camera in robot frame)."""
    r1, t1 = pose_to_rt(pose1)
    r2, t2 = pose_to_rt(pose2)
    c1ri = cam1_r.transpose(-1, -2)
    c1ti = -bmv(c1ri, cam1_t)
    r1i = r1.transpose(-1, -2)
    t1i = -bmv(r1i, t1)
    ra, ta = compose_rt(c1ri, c1ti, r1i, t1i)
    rb, tb = compose_rt(ra, ta, r2, t2)
    rc, tc = compose_rt(rb, tb, cam2_r, cam2_t)
    return bmm(skew(tc), rc)


def project_point_rectified(pose, point, cam_from_robot_r, cam_from_robot_t):
    """World point -> rectified pixel (x/z, y/z) and camera depth."""
    r_wr_inv, t_wr_inv = pose_inverse_rt(pose)
    p_robot = transform_point(r_wr_inv, t_wr_inv, point)
    p_cam = transform_point(cam_from_robot_r, cam_from_robot_t, p_robot)
    return p_cam[..., 0:2] / p_cam[..., 2:3], p_cam[..., 2]


def ellipsoid_dual_diag(ellipsoid):
    """diag((d/2)^2 + eps, -1) of the origin-centred dual quadric."""
    d = (ellipsoid[..., 4:7] * 0.5) ** 2 + DIM_REGULARIZATION
    return torch.cat([d, -torch.ones_like(d[..., :1])], -1)


def rot_z(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1), torch.stack([z, z, o], -1)],
        -2,
    )


def ellipsoid_corners_rectified(ellipsoid, pose, cam_from_robot_r, cam_from_robot_t):
    """Predicted rectified bbox corners of an ellipsoid seen from a pose.

    q = E diag((d/2)^2 + 1e-3, -1) E^T with E the 3x4 ellipsoid-to-camera
    transform; corners = [q13 +- sx, q23 +- sy] / q33 with
    sx = sqrt(q13^2 - q11 q33), sy = sqrt(q23^2 - q22 q33).

    Returns ``(corners4, valid)``; ``valid`` is False when either inner term
    is <= 0. The sqrt arguments are clamped and q33 guarded, so corners stay
    finite when invalid and the caller masks them."""
    r_wr_inv, t_wr_inv = pose_inverse_rt(pose)
    r_wc, t_wc = compose_rt(cam_from_robot_r, cam_from_robot_t, r_wr_inv, t_wr_inv)
    r_ce, t_ce = compose_rt(r_wc, t_wc, rot_z(ellipsoid[..., 3]), ellipsoid[..., 0:3])
    e_mat = torch.cat([r_ce, t_ce[..., :, None]], -1)
    d = ellipsoid_dual_diag(ellipsoid)
    q = bmm(e_mat * d[..., None, :], e_mat.transpose(-1, -2))
    q11, q13 = q[..., 0, 0], q[..., 0, 2]
    q22, q23 = q[..., 1, 1], q[..., 1, 2]
    q33 = q[..., 2, 2]
    x_inner = q13 * q13 - q11 * q33
    y_inner = q23 * q23 - q22 * q33
    valid = (x_inner > 0) & (y_inner > 0)
    sx = torch.sqrt(torch.clamp(x_inner, min=1e-12))
    sy = torch.sqrt(torch.clamp(y_inner, min=1e-12))
    corners = torch.stack([q13 + sx, q13 - sx, q23 + sy, q23 - sy], -1)
    q33_safe = torch.where(torch.abs(q33) < 1e-12, torch.full_like(q33, 1e-12), q33)
    return corners / q33_safe[..., None], valid
