"""The global bundle adjustment problems of the ``gba`` cells, in numpy.

``synthetic_problem`` is a frozen copy of the program's generator of the
same name (a joint object-visual BA over a trajectory along +x): the same
draws from ``numpy.random.default_rng(seed)`` in the same order, so one seed
gives the program and the reference the same arrays. It returns plain
arrays; the driver hands them to the program's own table and plan builders,
and the reference builds its own problem from them. ``out_and_back``
relabels a problem's poses so that the robot drives the line out and back:
landmarks are then seen again up to P - 1 poses apart, a loop closure.
"""

from __future__ import annotations

import numpy as np

FX = FY = 500.0
CX, CY = 320.0, 240.0


def rotvec_to_matrix(w):
    """Batched Rodrigues."""
    w = np.atleast_2d(w)
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-12
    theta_safe = np.where(small, 1.0, theta)
    a = np.where(small, 1.0, np.sin(theta_safe) / theta_safe)
    b = np.where(small, 0.5, (1.0 - np.cos(theta_safe)) / theta_safe**2)
    zeros = np.zeros_like(w[:, 0])
    s = np.stack([
        np.stack([zeros, -w[:, 2], w[:, 1]], -1),
        np.stack([w[:, 2], zeros, -w[:, 0]], -1),
        np.stack([-w[:, 1], w[:, 0], zeros], -1),
    ], axis=-2)
    return np.eye(3) + a[:, None, None] * s + b[:, None, None] * (s @ s)


def _project(poses, points):
    r = rotvec_to_matrix(poses[:, 3:6])
    p_cam = np.einsum("nji,nj->ni", r, points - poses[:, :3])
    return p_cam[:, :2] / p_cam[:, 2:3], p_cam[:, 2]


def ellipsoid_corners(ellipsoids, poses):
    """Rectified dual-quadric corners of yaw-only ellipsoids seen from
    ``poses`` by a camera at the robot's origin: (corners, valid)."""
    n = len(poses)
    r_wr = rotvec_to_matrix(poses[:, 3:6])
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
    d = np.concatenate([(ellipsoids[:, 4:7] * 0.5) ** 2 + 1e-3, -np.ones((n, 1))], axis=-1)
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


def synthetic_problem(n_poses=64, n_points=512, n_objects=8, obs_per_point=6,
                      obs_per_object=12, noise_px=0.5, pose_noise=0.03, point_noise=0.1,
                      seed=0):
    """A dict of float64 / int64 arrays: the ground truth (``gt_*``), the
    initial state (``poses``, ``points``, ``objects``), the factor rows
    (``reproj_*``, ``relpose_*``, ``bbox_*``, ``shape_*``) and ``free_poses``
    (pose 0 is the gauge)."""
    rng = np.random.default_rng(seed)
    gt_poses = np.zeros((n_poses, 6))
    gt_poses[:, 0] = np.arange(n_poses) * 0.3
    gt_poses[:, 4] = 0.05 * np.sin(np.arange(n_poses) * 0.3)
    gt_points = np.stack([
        gt_poses[rng.integers(0, n_poses, n_points), 0] + rng.uniform(-4, 4, n_points),
        rng.uniform(-3, 3, n_points),
        rng.uniform(4, 20, n_points),
    ], axis=1)
    gt_objects = np.concatenate([
        gt_poses[rng.integers(0, n_poses, n_objects), 0:1] + rng.uniform(-3, 3, (n_objects, 1)),
        rng.uniform(-1, 1, (n_objects, 1)),
        rng.uniform(6, 12, (n_objects, 1)),
        rng.uniform(-0.5, 0.5, (n_objects, 1)),
        1.0 + rng.uniform(0, 1, (n_objects, 3)),
    ], axis=1)

    cand = np.argsort(np.abs(gt_poses[None, :, 0] - gt_points[:, None, 0] + 4.0),
                      axis=1)[:, : obs_per_point * 2]
    flat_pose = cand.ravel()
    flat_point = np.repeat(np.arange(n_points), cand.shape[1])
    proj, depth = _project(gt_poses[flat_pose], gt_points[flat_point])
    ok = depth > 1.0
    order = np.lexsort((np.arange(len(flat_point)), ~ok, flat_point))
    keep_rows = _first_per_group(order, flat_point, ok, obs_per_point)
    pose_idx = flat_pose[keep_rows]
    pt_idx = flat_point[keep_rows]
    obs = proj[keep_rows] + rng.normal(size=(len(keep_rows), 2)) * noise_px / FX
    mult = np.full((len(keep_rows), 2), FX / 2.0)

    r_all = rotvec_to_matrix(gt_poses[:, 3:6])
    rel_r = np.swapaxes(r_all[:-1], -1, -2) @ r_all[1:]
    rel_t = np.einsum("nji,nj->ni", r_all[:-1], gt_poses[1:, :3] - gt_poses[:-1, :3])
    si6 = np.broadcast_to(np.diag([50.0] * 3 + [100.0] * 3), (n_poses - 1, 6, 6))

    cand_o = np.argsort(np.abs(gt_poses[None, :, 0] - gt_objects[:, None, 0] + 5.0),
                        axis=1)[:, : obs_per_object * 2]
    flat_o_pose = cand_o.ravel()
    flat_o_obj = np.repeat(np.arange(n_objects), cand_o.shape[1])
    corners, valid = ellipsoid_corners(gt_objects[flat_o_obj], gt_poses[flat_o_pose])
    keep_o = _first_per_group(range(len(flat_o_obj)), flat_o_obj, valid, obs_per_object)
    s_inf = np.diag([1 / 30.0] * 4) @ np.diag([FX, FX, FY, FY])
    bbox_corners = corners[keep_o] + rng.normal(size=(len(keep_o), 4)) * 2.0 / FX
    shape_mean = gt_objects[:, 4:7] + rng.normal(size=(n_objects, 3)) * 0.1

    poses0 = gt_poses.copy()
    poses0[1:] += rng.normal(size=(n_poses - 1, 6)) * pose_noise
    points0 = gt_points + rng.normal(size=gt_points.shape) * point_noise
    objects0 = gt_objects + rng.normal(size=gt_objects.shape) * 0.1
    return dict(
        gt_poses=gt_poses, gt_points=gt_points, gt_objects=gt_objects,
        poses=poses0, points=points0, objects=objects0,
        free_poses=np.arange(n_poses) != 0,
        reproj_pose=pose_idx, reproj_point=pt_idx, reproj_obs=obs, reproj_mult=mult,
        relpose_before=np.arange(n_poses - 1), relpose_after=np.arange(1, n_poses),
        relpose_t=rel_t, relpose_r=rel_r, relpose_sqrt_inf=np.ascontiguousarray(si6),
        bbox_obj=flat_o_obj[keep_o], bbox_pose=flat_o_pose[keep_o], bbox_corners=bbox_corners,
        bbox_sqrt_inf=np.ascontiguousarray(np.broadcast_to(s_inf, (len(keep_o), 4, 4))),
        shape_obj=np.arange(n_objects), shape_mean=shape_mean,
        shape_sqrt_inf=np.ascontiguousarray(np.broadcast_to(np.diag([2.0] * 3),
                                                            (n_objects, 3, 3))),
    )


def out_and_back(prob):
    """``prob`` with its poses relabelled: new pose k < P/2 is old pose 2k,
    k >= P/2 is old 2(P-1-k)+1 (pose 0 stays the gauge). Every pose index,
    the poses and the free mask are permuted; the problem is the same."""
    n_pose = len(prob["poses"])
    k = np.arange(n_pose)
    old_of_new = np.where(k < n_pose // 2, 2 * k, 2 * (n_pose - 1 - k) + 1)
    new_of_old = np.argsort(old_of_new)
    out = dict(prob)
    for key in ("reproj_pose", "bbox_pose", "relpose_before", "relpose_after"):
        out[key] = new_of_old[prob[key]]
    for key in ("gt_poses", "poses", "free_poses"):
        out[key] = prob[key][old_of_new]
    return out
