"""Pairwise 2-D feature (epipolar) factor: the reference's legacy factor
type 1 (``pairwise_2d_feature_cost_functor.h``), the port's counterpart of
``obvi_slam_tpu/factors/epipolar.py``:

    residual = x1^T E x2 / (sigma * sqrt(x1^T E^T E x1)),  1-dim

with E the essential matrix between the camera at two robot poses and
x_i = K_i^-1 [px, py, 1] the normalized image coordinates.

The reference declares this factor but its residual creator rejects it for
the reprojection-feature pose graph (residual_creator.h:383-385 "Pairwise
error factor type not supported"), so it stands alone (pose-pair-only
problems, the Jacobian tools) and is not wired into the BA tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from obvi_slam_tpu_torch import geometry as geo


class EpipolarFactors(NamedTuple):
    pose1_idx: torch.Tensor  # (E,) int32
    pose2_idx: torch.Tensor  # (E,) int32
    x1: torch.Tensor  # (E, 3) normalized image coords in camera 1
    x2: torch.Tensor  # (E, 3) normalized image coords in camera 2
    cam1_r: torch.Tensor  # (E, 3, 3) extrinsics (camera in robot frame)
    cam1_t: torch.Tensor  # (E, 3)
    cam2_r: torch.Tensor  # (E, 3, 3)
    cam2_t: torch.Tensor  # (E, 3)
    inv_sigma: torch.Tensor  # (E,)
    mask: torch.Tensor  # (E,)

    @property
    def capacity(self):
        return self.pose1_idx.shape[0]


def make_epipolar_factors(
    pose1_idx, pose2_idx, pixel1, pixel2, k1, k2, cam1_r, cam1_t, cam2_r, cam2_t,
    sigma, capacity=None, dtype=np.float64, device="cuda",
):
    """Pixels -> normalized image coords K^-1 [px py 1]; rows padded to
    ``capacity`` and masked."""
    n = len(pose1_idx)
    capacity = capacity or max(n, 1)

    def norm_coords(pixels, ks):
        if not n:
            return np.zeros((0, 3))
        hom = np.concatenate([np.asarray(pixels, np.float64).reshape(n, 2), np.ones((n, 1))], 1)
        k_inv = np.linalg.inv(np.asarray(ks, np.float64).reshape(n, 3, 3))
        return (k_inv @ hom[:, :, None])[..., 0]

    def pad(a, shape):
        out = np.zeros((capacity,) + shape, dtype=dtype)
        if n:
            out[:n] = np.reshape(a, (n,) + shape)
        return torch.from_numpy(out).to(device)

    def padi(a):
        out = np.zeros(capacity, dtype=np.int32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    mask = np.zeros(capacity, dtype=bool)
    mask[:n] = True
    return EpipolarFactors(
        pose1_idx=padi(pose1_idx),
        pose2_idx=padi(pose2_idx),
        x1=pad(norm_coords(pixel1, k1), (3,)),
        x2=pad(norm_coords(pixel2, k2), (3,)),
        cam1_r=pad(cam1_r, (3, 3)),
        cam1_t=pad(cam1_t, (3,)),
        cam2_r=pad(cam2_r, (3, 3)),
        cam2_t=pad(cam2_t, (3,)),
        inv_sigma=pad(np.full(n, 1.0 / sigma), ()),
        mask=torch.from_numpy(mask).to(device),
    )


def _epipolar_single(pose1, pose2, x1, x2, c1r, c1t, c2r, c2t, inv_sigma):
    e = geo.essential_matrix(pose1, pose2, c1r, c1t, c2r, c2t)
    err = (x1 * geo.bmv(e, x2)).sum(-1)
    scale = (x1 * geo.bmv(e.transpose(-1, -2), geo.bmv(e, x1))).sum(-1)
    return err * inv_sigma / torch.sqrt(torch.clamp(scale, min=1e-30))


def _gather(state, f):
    return (
        state.poses[f.pose1_idx.long()], state.poses[f.pose2_idx.long()], f.x1, f.x2,
        f.cam1_r, f.cam1_t, f.cam2_r, f.cam2_t, f.inv_sigma,
    )


def epipolar_residuals(state, f: EpipolarFactors):
    """(E,) residuals; masked rows are 0."""
    r = _epipolar_single(*_gather(state, f))
    return torch.where(f.mask, r, torch.zeros_like(r))


def epipolar_residuals_and_jac(state, f: EpipolarFactors):
    """Returns (r (E,), J_pose1 (E, 6), J_pose2 (E, 6)), by forward-mode AD,
    in the residual's dtype; masked rows are 0."""

    def with_aux(*args):
        r = _epipolar_single(*args)
        return r, r

    (j1, j2), r = vmap(jacfwd(with_aux, argnums=(0, 1), has_aux=True))(*_gather(state, f))
    m = f.mask

    def masked(x):
        x = x.to(r.dtype)
        return torch.where(m.reshape((-1,) + (1,) * (x.dim() - 1)), x, torch.zeros_like(x))

    return masked(r), masked(j1), masked(j2)
