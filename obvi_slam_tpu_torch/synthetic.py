"""Synthetic joint object-visual BA window (numpy generation, torch tables).

Counterpart of ``obvi_slam_tpu/synthetic.py::synthetic_problem``: the same
generator draws, in the same order, from ``numpy.random.default_rng(seed)``,
so equal seeds give equal arrays. Poses advance along +x; points and
ellipsoids lie ahead of the trajectory; each point is seen from up to
``obs_per_point`` poses and each object from up to ``obs_per_object``.
"""

from __future__ import annotations

import numpy as np
import torch

from obvi_slam_tpu_torch import types as T
from obvi_slam_tpu_torch.solver import plan as plan_mod
from obvi_slam_tpu_torch.solver.schur import HuberParams, ones_weights


def _np_rotvec_to_matrix(w):
    """Batched numpy Rodrigues."""
    w = np.atleast_2d(w)
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-12
    theta_safe = np.where(small, 1.0, theta)
    a = np.where(small, 1.0, np.sin(theta_safe) / theta_safe)
    b = np.where(small, 0.5, (1.0 - np.cos(theta_safe)) / theta_safe**2)
    zeros = np.zeros_like(w[:, 0])
    s = np.stack(
        [
            np.stack([zeros, -w[:, 2], w[:, 1]], -1),
            np.stack([w[:, 2], zeros, -w[:, 0]], -1),
            np.stack([-w[:, 1], w[:, 0], zeros], -1),
        ],
        axis=-2,
    )
    return np.eye(3) + a[:, None, None] * s + b[:, None, None] * (s @ s)


def _np_project(poses, points):
    """Rectified projection of points (N,3) from poses (N,6): (proj, depth)."""
    r = _np_rotvec_to_matrix(poses[:, 3:6])
    p_cam = np.einsum("nji,nj->ni", r, points - poses[:, :3])
    return p_cam[:, :2] / p_cam[:, 2:3], p_cam[:, 2]


def _np_ellipsoid_corners(ellipsoids, poses):
    """Batched numpy dual-quadric corners (identity camera): (corners, valid)."""
    n = len(poses)
    r_wr = _np_rotvec_to_matrix(poses[:, 3:6])
    r_wc = np.swapaxes(r_wr, -1, -2)
    t_wc = -np.einsum("nij,nj->ni", r_wc, poses[:, :3])
    yaw = ellipsoids[:, 3]
    c, s = np.cos(yaw), np.sin(yaw)
    r_e = np.zeros((n, 3, 3))
    r_e[:, 0, 0] = c
    r_e[:, 0, 1] = -s
    r_e[:, 1, 0] = s
    r_e[:, 1, 1] = c
    r_e[:, 2, 2] = 1.0
    r_ce = r_wc @ r_e
    t_ce = np.einsum("nij,nj->ni", r_wc, ellipsoids[:, :3]) + t_wc
    e_mat = np.concatenate([r_ce, t_ce[:, :, None]], axis=-1)
    d = np.concatenate(
        [(ellipsoids[:, 4:7] * 0.5) ** 2 + 1e-3, -np.ones((n, 1))], axis=-1
    )
    q = np.einsum("nik,nk,njk->nij", e_mat, d, e_mat)
    q11, q13 = q[:, 0, 0], q[:, 0, 2]
    q22, q23 = q[:, 1, 1], q[:, 1, 2]
    q33 = q[:, 2, 2]
    x_inner = q13 * q13 - q11 * q33
    y_inner = q23 * q23 - q22 * q33
    valid = (x_inner > 0) & (y_inner > 0)
    sx = np.sqrt(np.maximum(x_inner, 1e-12))
    sy = np.sqrt(np.maximum(y_inner, 1e-12))
    corners = np.stack([q13 + sx, q13 - sx, q23 + sy, q23 - sy], axis=-1)
    return corners / np.where(np.abs(q33) < 1e-12, 1e-12, q33)[:, None], valid


def _first_per_group(rows, groups, ok, limit):
    """Rows (in the given order) that are ok, at most ``limit`` per group."""
    keep, count = [], {}
    for row in rows:
        if not ok[row]:
            continue
        g = groups[row]
        c = count.get(g, 0)
        if c < limit:
            keep.append(row)
            count[g] = c + 1
    return np.array(keep, dtype=np.int64)


def synthetic_problem(
    n_poses=64,
    n_points=512,
    n_objects=8,
    obs_per_point=6,
    obs_per_object=12,
    noise_px=0.5,
    pose_noise=0.03,
    point_noise=0.1,
    seed=0,
    dtype=np.float64,
    device="cuda",
):
    """Returns (state0, state_gt, cams, tables, plan, free, weights, huber)."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0

    gt_poses = np.zeros((n_poses, 6))
    gt_poses[:, 0] = np.arange(n_poses) * 0.3
    gt_poses[:, 4] = 0.05 * np.sin(np.arange(n_poses) * 0.3)
    gt_points = np.stack(
        [
            gt_poses[rng.integers(0, n_poses, n_points), 0]
            + rng.uniform(-4, 4, n_points),
            rng.uniform(-3, 3, n_points),
            rng.uniform(4, 20, n_points),
        ],
        axis=1,
    )
    gt_objects = np.concatenate(
        [
            gt_poses[rng.integers(0, n_poses, n_objects), 0:1]
            + rng.uniform(-3, 3, (n_objects, 1)),
            rng.uniform(-1, 1, (n_objects, 1)),
            rng.uniform(6, 12, (n_objects, 1)),
            rng.uniform(-0.5, 0.5, (n_objects, 1)),
            1.0 + rng.uniform(0, 1, (n_objects, 3)),
        ],
        axis=1,
    )
    cams = T.make_camera_bundle(
        np.eye(3)[None], np.zeros((1, 3)), [fx], [fy], [cx], [cy], dtype, device
    )

    # Reprojection factors from candidate poses trailing each point in x.
    cand = np.argsort(
        np.abs(gt_poses[None, :, 0] - gt_points[:, None, 0] + 4.0), axis=1
    )[:, : obs_per_point * 2]
    flat_pose = cand.ravel()
    flat_point = np.repeat(np.arange(n_points), cand.shape[1])
    proj, depth = _np_project(gt_poses[flat_pose], gt_points[flat_point])
    ok = depth > 1.0
    order = np.lexsort((np.arange(len(flat_point)), ~ok, flat_point))
    keep_rows = _first_per_group(order, flat_point, ok, obs_per_point)
    pose_idx = flat_pose[keep_rows]
    pt_idx = flat_point[keep_rows]
    obs = proj[keep_rows] + rng.normal(size=(len(keep_rows), 2)) * noise_px / fx
    mult = np.full((len(keep_rows), 2), fx / 2.0)
    reproj = T.make_reprojection_factors(
        pose_idx, pt_idx, np.zeros(len(keep_rows), np.int64), obs, mult,
        dtype=dtype, device=device,
    )

    # Relative-pose odometry chain.
    r_all = _np_rotvec_to_matrix(gt_poses[:, 3:6])
    rel_r = np.swapaxes(r_all[:-1], -1, -2) @ r_all[1:]
    rel_t = np.einsum("nji,nj->ni", r_all[:-1], gt_poses[1:, :3] - gt_poses[:-1, :3])
    si6 = np.broadcast_to(np.diag([50.0] * 3 + [100.0] * 3), (n_poses - 1, 6, 6))
    relpose = T.make_relative_pose_factors(
        np.arange(n_poses - 1), np.arange(1, n_poses), rel_t, rel_r, si6,
        dtype=dtype, device=device,
    )

    # Object observations and shape priors.
    cand_o = np.argsort(
        np.abs(gt_poses[None, :, 0] - gt_objects[:, None, 0] + 5.0), axis=1
    )[:, : obs_per_object * 2]
    flat_o_pose = cand_o.ravel()
    flat_o_obj = np.repeat(np.arange(n_objects), cand_o.shape[1])
    corners, valid = _np_ellipsoid_corners(gt_objects[flat_o_obj], gt_poses[flat_o_pose])
    keep_o = _first_per_group(range(len(flat_o_obj)), flat_o_obj, valid, obs_per_object)
    s_inf = np.diag([1 / 30.0] * 4) @ np.diag([fx, fx, fy, fy])
    bbox = T.make_bounding_box_factors(
        flat_o_obj[keep_o],
        flat_o_pose[keep_o],
        np.zeros(len(keep_o), np.int64),
        corners[keep_o] + rng.normal(size=(len(keep_o), 4)) * 2.0 / fx,
        np.broadcast_to(s_inf, (len(keep_o), 4, 4)),
        dtype=dtype,
        device=device,
    )
    shape = T.make_shape_prior_factors(
        np.arange(n_objects),
        gt_objects[:, 4:7] + rng.normal(size=(n_objects, 3)) * 0.1,
        np.broadcast_to(np.diag([2.0] * 3), (n_objects, 3, 3)),
        dtype=dtype,
        device=device,
    )
    tables = T.FactorTables(
        reproj=reproj,
        bbox=bbox,
        shape=shape,
        relpose=relpose,
        ltm=T.empty_ltm_prior_factors(dtype=dtype, device=device),
        param_prior=T.empty_param_prior_factors(dtype=dtype, device=device),
    )
    plan = plan_mod.build_schur_plan_host(
        pose_idx, pt_idx, reproj.capacity, flat_o_pose[keep_o], flat_o_obj[keep_o],
        bbox.capacity, n_pose=n_poses, rl_before=np.arange(n_poses - 1),
        rl_after=np.arange(1, n_poses), rl_cap=relpose.capacity, device=device,
    )

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    state_gt = T.BAState(
        poses=t(gt_poses.astype(dtype)),
        points=t(gt_points.astype(dtype)),
        objects=t(gt_objects.astype(dtype)),
    )
    poses0 = gt_poses.copy()
    poses0[1:] += rng.normal(size=(n_poses - 1, 6)) * pose_noise
    state0 = T.BAState(
        poses=t(poses0.astype(dtype)),
        points=t((gt_points + rng.normal(size=gt_points.shape) * point_noise).astype(dtype)),
        objects=t((gt_objects + rng.normal(size=gt_objects.shape) * 0.1).astype(dtype)),
    )
    free = T.FreeMasks(
        poses=t(np.arange(n_poses) != 0),
        points=t(np.ones(n_points, dtype=bool)),
        objects=t(np.ones(n_objects, dtype=bool)),
    )
    weights = ones_weights(tables, dtype=state0.poses.dtype)
    return state0, state_gt, cams, tables, plan, free, weights, HuberParams()
