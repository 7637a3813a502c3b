"""Plain PyTorch geometry of the reference: rotations, projection and the
dual-quadric bounding box of a yaw-only ellipsoid.

Written from the equations, not from the program: a pose is [t, axis-angle]
with R mapping robot to world, a camera takes robot coordinates to camera
coordinates by (R_c, t_c), and a bounding box is the axis-aligned extent of
the projected dual quadric diag((d/2)^2 + 1e-3, -1) in rectified
coordinates. Every function takes batched tensors and works under
``torch.func`` transforms (no in-place writes, no data-dependent branches).
"""

from __future__ import annotations

import torch

# Added to each squared half-dimension of an ellipsoid's dual quadric, as the
# ObVi-SLAM residual does, so that a flat ellipsoid still projects.
DIM_REGULARIZATION = 1e-3


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def exp_so3(w):
    """Rodrigues' formula; the second-order series below 1e-4 rad. (Scalars
    keep a trailing axis: forward-mode AD would promote a 0-dim float32
    tangent met with a Python float to float64.)"""
    theta2 = (w * w).sum(-1, keepdim=True)
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + a[..., None] * k + b[..., None] * (k @ k)


def log_so3(r):
    """Axis-angle of a rotation matrix (angles below pi - 1e-3)."""
    v = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1) * 0.5
    cos = ((r[..., 0, 0:1] + r[..., 1, 1:2] + r[..., 2, 2:3]) - 1.0) * 0.5
    sin2 = (v * v).sum(-1, keepdim=True)
    small = sin2 < 1e-12
    sin = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    theta = torch.atan2(sin, cos)
    return v * torch.where(small, 1.0 + sin2 / 6.0, theta / sin)


def world_to_camera(pose, cam_r, cam_t, p_world):
    """Camera coordinates of world points seen from robot ``pose``."""
    r = exp_so3(pose[..., 3:6])
    p_robot = (r.transpose(-1, -2) @ (p_world - pose[..., 0:3])[..., None])[..., 0]
    return (cam_r @ p_robot[..., None])[..., 0] + cam_t


def project(pose, point, cam_r, cam_t):
    """Rectified projection (x/z, y/z) of a world point."""
    p = world_to_camera(pose, cam_r, cam_t, point)
    return p[..., 0:2] / p[..., 2:3]


def rot_z(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def ellipsoid_box(ellipsoid, pose, cam_r, cam_t):
    """([x_min, x_max, y_min, y_max] in rectified coordinates, valid): the
    tangent lines of the projected dual quadric; not valid where the camera
    sits inside the ellipsoid or the box degenerates."""
    r_wr = exp_so3(pose[..., 3:6])
    r_cw = cam_r @ r_wr.transpose(-1, -2)
    t_cw = cam_t - (r_cw @ pose[..., 0:3, None])[..., 0]
    r_ce = r_cw @ rot_z(ellipsoid[..., 3])
    t_ce = (r_cw @ ellipsoid[..., 0:3, None])[..., 0] + t_cw
    e = torch.cat([r_ce, t_ce[..., None]], -1)  # (..., 3, 4)
    half = (ellipsoid[..., 4:7] * 0.5) ** 2 + DIM_REGULARIZATION
    diag = torch.cat([half, -torch.ones_like(half[..., :1])], -1)
    q = (e * diag[..., None, :]) @ e.transpose(-1, -2)
    q11, q13, q22 = q[..., 0, 0:1], q[..., 0, 2:3], q[..., 1, 1:2]
    q23, q33 = q[..., 1, 2:3], q[..., 2, 2:3]
    x_in = q13 * q13 - q11 * q33
    y_in = q23 * q23 - q22 * q33
    valid = ((x_in > 0) & (y_in > 0))[..., 0]
    sx = torch.sqrt(torch.clamp(x_in, min=1e-12))
    sy = torch.sqrt(torch.clamp(y_in, min=1e-12))
    den = torch.where(torch.abs(q33) < 1e-12, torch.full_like(q33, 1e-12), q33)
    box = torch.cat([q13 + sx, q13 - sx, q23 + sy, q23 - sy], -1) / den
    return box, valid
