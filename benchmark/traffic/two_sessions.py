"""Two sessions of one world for the ``ltm`` cells: the dense cell's route
driven twice.

The world is ``object_session``'s: chairs on ``chair_grid`` in two rows
along +x. Session 1 drives ``n_frames[0]`` frames of the route; session 2
drives its first ``n_frames[1]`` frames again, with its own draw of
features, pixel noise, detection noise and odometry drift. Both start at
the same ground-truth origin, so both initial trajectories are given in
one frame, the long-term map's. ``--seed`` gives the two sessions' seeds
(``numpy.random.SeedSequence``); one seed gives the same two sessions.

``detection_objects`` names the chair of each detection (the nearest
noise-free box in its frame and camera), the ground truth of the
association checks.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import object_session
from benchmark.traffic.object_session import C_X, C_Y, F

# Pixels a detection may lie from its chair's noise-free box (1 px of
# noise a corner).
MATCH_PX = 10.0


def session_seeds(seed: int):
    """The two sessions' generator seeds of a cell's ``--seed``."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(2)]


def two_sessions(seed, n_objects, n_frames, n_features, baseline, odom_noise):
    """(session 1, session 2) of ``object_session.synthetic_object_session``;
    ``n_frames`` and ``n_features`` hold one number per session."""
    return tuple(
        object_session.synthetic_object_session(
            n_frames=n_frames[i], seed=s, n_objects=n_objects, n_features=n_features[i],
            baseline=baseline, odom_noise=odom_noise)
        for i, s in enumerate(session_seeds(seed)))


def detection_objects(s) -> np.ndarray:
    """The chair index of each of session ``s``'s detections."""
    out = np.full(len(s.det_frame), -1, np.int64)
    for cam_id, _, ext_r, ext_t in s.cameras:
        corners, valid = object_session._cam_boxes(s.gt_objects, s.gt_poses, ext_r.T,
                                                   -ext_r.T @ ext_t)
        px = np.stack([F * corners[..., 0] + C_X, F * corners[..., 1] + C_X,
                       F * corners[..., 2] + C_Y, F * corners[..., 3] + C_Y], -1)
        px = np.where(valid[..., None], px, np.inf)
        rows = np.nonzero(s.det_cam == cam_id)[0]
        dist = np.max(np.abs(px[s.det_frame[rows]] - s.det_px[rows, None, :]), -1)
        best = np.argmin(dist, 1)
        ok = dist[np.arange(len(rows)), best] <= MATCH_PX
        out[rows[ok]] = best[ok]
    return out
