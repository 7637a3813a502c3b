"""The object-visual sessions of the ``objects`` cells, in numpy.

``synthetic_object_session`` is a frozen, vectorized copy of the program's
generator of the same name: a stereo rig driving along +x past chairs in two
rows, each chair carrying ten surface features, the rest of the features in
the background, feature tracks with 0.3 px of noise, projected-ellipsoid
detections with 1 px of noise at confidence 0.9, and an initial trajectory
integrated from noisy odometry (it drifts). It makes the same draws from
``numpy.random.default_rng(seed)`` in the same order, so one seed gives the
same session; its loops over features and frames are array operations.
Any number of chairs but two sits on ``chair_grid`` (2.2 m apart in x, rows
2.5 m apart in y, from x = -1.4 m).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.spatial.transform import Rotation

from benchmark.traffic.problem import rotvec_to_matrix

CHAIR_DIMS = (0.62, 0.62, 0.975)
_TWO_CHAIRS = np.array([[1.0, 0.5, 7.0, 0.0, *CHAIR_DIMS], [-1.8, 0.4, 10.0, 0.0, *CHAIR_DIMS]])
F, C_X, C_Y = 500.0, 320.0, 240.0
WIDTH, HEIGHT = 640, 480


@dataclass
class Session:
    """Raw session arrays. ``cameras``: [(id, K, extrinsics R, t)], robot
    from camera. Observations of the kept tracks (at least two frames):
    ``obs_feat``, ``obs_frame``, ``obs_cam`` (camera id), ``obs_px`` (N, 2),
    in (feature, frame, camera) order. ``feat_ids`` / ``feat_init`` (the
    initial 3-D positions of the kept tracks). Detections: ``det_frame``,
    ``det_cam``, ``det_px`` (D, 4) [x_min, x_max, y_min, y_max], in (frame,
    camera, chair) order, all "chair" at ``det_conf``."""

    cameras: list
    gt_poses: np.ndarray
    gt_objects: np.ndarray
    init_poses: np.ndarray
    feat_positions: np.ndarray
    obs_feat: np.ndarray
    obs_frame: np.ndarray
    obs_cam: np.ndarray
    obs_px: np.ndarray
    feat_ids: np.ndarray
    feat_init: np.ndarray
    det_frame: np.ndarray
    det_cam: np.ndarray
    det_px: np.ndarray
    det_conf: float = 0.9


def chair_grid(n_objects, dims):
    k = np.arange(n_objects)
    col, row = k // 2, k % 2
    return np.stack([
        -1.4 + 2.2 * col + 1.1 * row,
        np.where(row == 0, -1.0, 1.5),
        np.where(row == 0, 7.0, 10.0),
        np.zeros(n_objects),
        *(np.full(n_objects, d) for d in dims),
    ], axis=1)


def _cam_boxes(objects, poses, cam_r, cam_t):
    """Rectified dual-quadric boxes (P, O, 4) and validity of every chair
    seen from every pose by one camera (cam_r, cam_t: robot to camera)."""
    r_wr = rotvec_to_matrix(poses[:, 3:6])  # (P, 3, 3)
    r_rw = np.swapaxes(r_wr, -1, -2)
    t_rw = -np.einsum("pij,pj->pi", r_rw, poses[:, :3])
    r_cw = np.einsum("ij,pjk->pik", cam_r, r_rw)
    t_cw = np.einsum("ij,pj->pi", cam_r, t_rw) + cam_t
    yaw = objects[:, 3]
    c, s = np.cos(yaw), np.sin(yaw)
    r_e = np.zeros((len(objects), 3, 3))
    r_e[:, 0, 0], r_e[:, 0, 1], r_e[:, 1, 0], r_e[:, 1, 1], r_e[:, 2, 2] = c, -s, s, c, 1.0
    r_ce = np.einsum("pij,ojk->poik", r_cw, r_e)
    t_ce = np.einsum("pij,oj->poi", r_cw, objects[:, :3]) + t_cw[:, None, :]
    e_mat = np.concatenate([r_ce, t_ce[..., None]], -1)
    d = np.concatenate([(objects[:, 4:7] * 0.5) ** 2 + 1e-3, -np.ones((len(objects), 1))], -1)
    q = np.einsum("poik,ok,pojk->poij", e_mat, d, e_mat)
    q11, q13, q22, q23, q33 = (q[..., 0, 0], q[..., 0, 2], q[..., 1, 1], q[..., 1, 2],
                               q[..., 2, 2])
    x_in = q13 * q13 - q11 * q33
    y_in = q23 * q23 - q22 * q33
    valid = (x_in > 0) & (y_in > 0)
    sx, sy = np.sqrt(np.maximum(x_in, 1e-12)), np.sqrt(np.maximum(y_in, 1e-12))
    box = np.stack([q13 + sx, q13 - sx, q23 + sy, q23 - sy], -1)
    return box / np.where(np.abs(q33) < 1e-12, 1e-12, q33)[..., None], valid


def synthetic_object_session(n_frames=14, seed=21, n_objects=2, n_features=40, baseline=None,
                             dims=None, odom_noise=None):
    rng = np.random.default_rng(seed)
    k = np.array([[F, 0, C_X], [0, F, C_Y], [0, 0, 1.0]])
    cameras = [(1, k, np.eye(3), np.zeros(3))]
    if baseline is not None:
        cameras.append((2, k, np.eye(3), np.array([baseline, 0.0, 0.0])))

    gt_poses = np.zeros((n_frames, 6))
    gt_poses[:, 0] = np.arange(n_frames) * 0.2
    dims = list(CHAIR_DIMS) if dims is None else list(dims)
    if n_objects == 2:
        gt_objects = _TWO_CHAIRS.copy()
        gt_objects[:, 4:7] = dims
    else:
        gt_objects = chair_grid(n_objects, dims)

    n_obj_feat = 10 * len(gt_objects)
    surface = (gt_objects[:, None, :3]
               + rng.uniform(-0.5, 0.5, (len(gt_objects), 10, 3)) * gt_objects[:, None, 4:7])
    x_hi = max(5.0, gt_poses[-1, 0] + 2.0)
    n_bg = max(0, n_features - n_obj_feat)
    background = rng.uniform([-5.0, -2.0, 4.0], [x_hi, 2.0, 15.0], (n_bg, 3))
    positions = np.concatenate([surface.reshape(-1, 3), background])

    # Tracks: every (feature, frame, camera) in view draws its noise in order.
    rot_w = np.stack([Rotation.from_rotvec(p[3:]).as_matrix() for p in gt_poses])
    px_all, vis_all = [], []
    for _, _, ext_r, ext_t in cameras:
        p_robot = np.einsum("fji,nfj->nfi", rot_w, positions[:, None, :] - gt_poses[None, :, :3])
        p_cam = np.einsum("ji,nfj->nfi", ext_r, p_robot - ext_t)
        z = p_cam[..., 2]
        zs = np.where(z > 0.3, z, 1.0)
        px = np.stack([F * p_cam[..., 0] / zs + C_X, F * p_cam[..., 1] / zs + C_Y], -1)
        vis = ((z > 0.3) & (px[..., 0] >= 0) & (px[..., 0] <= WIDTH) & (px[..., 1] >= 0)
               & (px[..., 1] <= HEIGHT))
        px_all.append(px)
        vis_all.append(vis)
    px_all = np.stack(px_all, 2)  # (feature, frame, camera, 2)
    vis_all = np.stack(vis_all, 2)
    feat, frame, cam = np.nonzero(vis_all)
    obs_px = px_all[feat, frame, cam] + rng.normal(size=(len(feat), 2)) * 0.3
    frames_seen = np.any(vis_all, axis=2).sum(1)
    kept = frames_seen >= 2
    sel = kept[feat]
    cam_ids = np.array([c[0] for c in cameras])

    # Detections: every valid (frame, camera, chair) draws its noise in order.
    boxes = []
    for _, _, ext_r, ext_t in cameras:
        boxes.append(_cam_boxes(gt_objects, gt_poses, ext_r.T, -ext_r.T @ ext_t))
    corners = np.stack([b[0] for b in boxes], 1)  # (frame, camera, chair, 4)
    valid = np.stack([b[1] for b in boxes], 1)
    d_frame, d_cam, d_obj = np.nonzero(valid)
    c = corners[d_frame, d_cam, d_obj]
    det_px = (np.stack([F * c[:, 0] + C_X, F * c[:, 1] + C_X, F * c[:, 2] + C_Y,
                        F * c[:, 3] + C_Y], -1) + rng.normal(size=(len(d_frame), 4)) * 1.0)
    inside = ~((det_px[:, 1] < 10) | (det_px[:, 0] > 630) | (det_px[:, 3] < 10)
               | (det_px[:, 2] > 470))

    if odom_noise is None:
        noise = rng.normal(size=(n_frames, 6))
        init = gt_poses + np.concatenate([noise[:, :3] * 0.01, noise[:, 3:] * 0.004], 1)
        init[0] = gt_poses[0]
    else:
        noise = rng.normal(size=(max(n_frames - 1, 0), 6))
        init = np.zeros_like(gt_poses)
        init[0] = gt_poses[0]
        for i in range(1, n_frames):
            rel_t = rot_w[i - 1].T @ (gt_poses[i, :3] - gt_poses[i - 1, :3])
            rel_t = rel_t + noise[i - 1, :3] * odom_noise
            rel_w = (Rotation.from_matrix(rot_w[i - 1].T @ rot_w[i]).as_rotvec()
                     + noise[i - 1, 3:] * odom_noise * 0.5)
            r_prev = Rotation.from_rotvec(init[i - 1][3:]).as_matrix()
            init[i] = np.concatenate([
                r_prev @ rel_t + init[i - 1][:3],
                Rotation.from_matrix(r_prev @ Rotation.from_rotvec(rel_w).as_matrix()).as_rotvec(),
            ])
    feat_ids = np.nonzero(kept)[0]
    feat_init = positions[feat_ids] + rng.normal(size=(len(feat_ids), 3)) * 0.05
    return Session(
        cameras=cameras, gt_poses=gt_poses, gt_objects=gt_objects, init_poses=init,
        feat_positions=positions, obs_feat=feat[sel], obs_frame=frame[sel],
        obs_cam=cam_ids[cam[sel]], obs_px=obs_px[sel], feat_ids=feat_ids, feat_init=feat_init,
        det_frame=d_frame[inside], det_cam=cam_ids[d_cam[inside]], det_px=det_px[inside],
    )
