"""Core state and factor-table types, as NamedTuples of torch tensors.

Counterpart of ``obvi_slam_tpu/types.py``: struct-of-arrays tables with
fixed capacities and validity masks. Tables are built on the host with numpy
(so padding rows are exactly zero) and moved once to ``device``.

Index columns are int32, masks bool, values ``dtype`` (float64 by default).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BAState(NamedTuple):
    """Optimizable state. Rows beyond the live counts are padding."""

    poses: torch.Tensor  # (P, 6)  [t, axis-angle]
    points: torch.Tensor  # (M, 3)
    objects: torch.Tensor  # (K, 7) [x, y, z, yaw, dx, dy, dz]


class CameraBundle(NamedTuple):
    """Per-camera constants (C cameras); ``cam_from_robot_*`` is the inverse
    of the extrinsics (robot pose in the camera frame)."""

    cam_from_robot_r: torch.Tensor  # (C, 3, 3)
    cam_from_robot_t: torch.Tensor  # (C, 3)
    fx: torch.Tensor  # (C,)
    fy: torch.Tensor  # (C,)
    cx: torch.Tensor  # (C,)
    cy: torch.Tensor  # (C,)


class ReprojectionFactors(NamedTuple):
    """residual_k = multiplier_k * (projected_rectified_k - rect_obs_k)."""

    pose_idx: torch.Tensor  # (F,) int32
    point_idx: torch.Tensor  # (F,) int32
    cam_idx: torch.Tensor  # (F,) int32
    rect_obs: torch.Tensor  # (F, 2)
    multiplier: torch.Tensor  # (F, 2)
    mask: torch.Tensor  # (F,) bool

    @property
    def capacity(self):
        return self.pose_idx.shape[0]


class BoundingBoxFactors(NamedTuple):
    """residual = sqrt_inf @ (predicted_rect_corners - rect_corners); all four
    entries saturate to ``invalid_ellipse_error`` on a degenerate projection."""

    obj_idx: torch.Tensor  # (B,) int32
    pose_idx: torch.Tensor  # (B,) int32
    cam_idx: torch.Tensor  # (B,) int32
    rect_corners: torch.Tensor  # (B, 4) [x_min, x_max, y_min, y_max]
    sqrt_inf: torch.Tensor  # (B, 4, 4)
    mask: torch.Tensor  # (B,) bool

    @property
    def capacity(self):
        return self.obj_idx.shape[0]


class ShapePriorFactors(NamedTuple):
    obj_idx: torch.Tensor  # (S,) int32
    mean_dim: torch.Tensor  # (S, 3)
    sqrt_inf: torch.Tensor  # (S, 3, 3)
    mask: torch.Tensor  # (S,) bool

    @property
    def capacity(self):
        return self.obj_idx.shape[0]


class RelativePoseFactors(NamedTuple):
    before_idx: torch.Tensor  # (R,) int32
    after_idx: torch.Tensor  # (R,) int32
    meas_t: torch.Tensor  # (R, 3)
    meas_r: torch.Tensor  # (R, 3, 3)
    sqrt_inf: torch.Tensor  # (R, 6, 6)
    mask: torch.Tensor  # (R,) bool

    @property
    def capacity(self):
        return self.before_idx.shape[0]


class LtmPriorFactors(NamedTuple):
    obj_idx: torch.Tensor  # (L,) int32
    mean: torch.Tensor  # (L, 7)
    sqrt_inf: torch.Tensor  # (L, 7, 7)
    mask: torch.Tensor  # (L,) bool

    @property
    def capacity(self):
        return self.obj_idx.shape[0]


class ParamPriorFactors(NamedTuple):
    """Unary prior on one scalar parameter; ``block_kind`` 0 = pose,
    1 = point, 2 = object."""

    block_kind: torch.Tensor  # (Q,) int32
    block_idx: torch.Tensor  # (Q,) int32
    param_idx: torch.Tensor  # (Q,) int32
    mean: torch.Tensor  # (Q,)
    inv_std: torch.Tensor  # (Q,)
    mask: torch.Tensor  # (Q,) bool

    @property
    def capacity(self):
        return self.block_kind.shape[0]


class FactorTables(NamedTuple):
    reproj: ReprojectionFactors
    bbox: BoundingBoxFactors
    shape: ShapePriorFactors
    relpose: RelativePoseFactors
    ltm: LtmPriorFactors
    param_prior: ParamPriorFactors


class FreeMasks(NamedTuple):
    """Which parameter blocks are variable (True) vs held constant."""

    poses: torch.Tensor  # (P,) bool
    points: torch.Tensor  # (M,) bool
    objects: torch.Tensor  # (K,) bool


def _pad(arr, capacity, dtype=None):
    arr = np.asarray(arr)
    if dtype is not None:
        arr = arr.astype(dtype)
    out = np.zeros((capacity,) + arr.shape[1:], dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _mask(n, capacity):
    m = np.zeros((capacity,), dtype=bool)
    m[:n] = True
    return m


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def make_reprojection_factors(
    pose_idx, point_idx, cam_idx, rect_obs, multiplier, capacity=None,
    dtype=np.float64, device="cuda",
):
    n = len(pose_idx)
    capacity = capacity or max(n, 1)
    return ReprojectionFactors(
        pose_idx=_t(_pad(pose_idx, capacity, np.int32), device),
        point_idx=_t(_pad(point_idx, capacity, np.int32), device),
        cam_idx=_t(_pad(cam_idx, capacity, np.int32), device),
        rect_obs=_t(_pad(np.reshape(rect_obs, (n, 2)), capacity, dtype), device),
        multiplier=_t(_pad(np.reshape(multiplier, (n, 2)), capacity, dtype), device),
        mask=_t(_mask(n, capacity), device),
    )


def make_bounding_box_factors(
    obj_idx, pose_idx, cam_idx, rect_corners, sqrt_inf, capacity=None,
    dtype=np.float64, device="cuda",
):
    n = len(obj_idx)
    capacity = capacity or max(n, 1)
    return BoundingBoxFactors(
        obj_idx=_t(_pad(obj_idx, capacity, np.int32), device),
        pose_idx=_t(_pad(pose_idx, capacity, np.int32), device),
        cam_idx=_t(_pad(cam_idx, capacity, np.int32), device),
        rect_corners=_t(
            _pad(np.reshape(rect_corners, (n, 4)), capacity, dtype), device
        ),
        sqrt_inf=_t(_pad(np.reshape(sqrt_inf, (n, 4, 4)), capacity, dtype), device),
        mask=_t(_mask(n, capacity), device),
    )


def make_shape_prior_factors(
    obj_idx, mean_dim, sqrt_inf, capacity=None, dtype=np.float64, device="cuda"
):
    n = len(obj_idx)
    capacity = capacity or max(n, 1)
    return ShapePriorFactors(
        obj_idx=_t(_pad(obj_idx, capacity, np.int32), device),
        mean_dim=_t(_pad(np.reshape(mean_dim, (n, 3)), capacity, dtype), device),
        sqrt_inf=_t(_pad(np.reshape(sqrt_inf, (n, 3, 3)), capacity, dtype), device),
        mask=_t(_mask(n, capacity), device),
    )


def make_relative_pose_factors(
    before_idx, after_idx, meas_t, meas_r, sqrt_inf, capacity=None,
    dtype=np.float64, device="cuda",
):
    n = len(before_idx)
    capacity = capacity or max(n, 1)
    return RelativePoseFactors(
        before_idx=_t(_pad(before_idx, capacity, np.int32), device),
        after_idx=_t(_pad(after_idx, capacity, np.int32), device),
        meas_t=_t(_pad(np.reshape(meas_t, (n, 3)), capacity, dtype), device),
        meas_r=_t(_pad(np.reshape(meas_r, (n, 3, 3)), capacity, dtype), device),
        sqrt_inf=_t(_pad(np.reshape(sqrt_inf, (n, 6, 6)), capacity, dtype), device),
        mask=_t(_mask(n, capacity), device),
    )


def make_ltm_prior_factors(
    obj_idx, mean, sqrt_inf, capacity=None, dtype=np.float64, device="cuda"
):
    n = len(obj_idx)
    capacity = capacity or max(n, 1)
    return LtmPriorFactors(
        obj_idx=_t(_pad(obj_idx, capacity, np.int32), device),
        mean=_t(_pad(np.reshape(mean, (n, 7)), capacity, dtype), device),
        sqrt_inf=_t(_pad(np.reshape(sqrt_inf, (n, 7, 7)), capacity, dtype), device),
        mask=_t(_mask(n, capacity), device),
    )


def make_param_prior_factors(
    block_kind, block_idx, param_idx, mean, inv_std, capacity=None,
    dtype=np.float64, device="cuda",
):
    n = len(block_kind)
    capacity = capacity or max(n, 1)
    return ParamPriorFactors(
        block_kind=_t(_pad(block_kind, capacity, np.int32), device),
        block_idx=_t(_pad(block_idx, capacity, np.int32), device),
        param_idx=_t(_pad(param_idx, capacity, np.int32), device),
        mean=_t(_pad(mean, capacity, dtype), device),
        inv_std=_t(_pad(inv_std, capacity, dtype), device),
        mask=_t(_mask(n, capacity), device),
    )


def empty_reprojection_factors(capacity=1, dtype=np.float64, device="cuda"):
    return make_reprojection_factors(
        [], [], [], np.zeros((0, 2)), np.zeros((0, 2)), capacity, dtype, device
    )


def empty_bounding_box_factors(capacity=1, dtype=np.float64, device="cuda"):
    return make_bounding_box_factors(
        [], [], [], np.zeros((0, 4)), np.zeros((0, 4, 4)), capacity, dtype, device
    )


def empty_shape_prior_factors(capacity=1, dtype=np.float64, device="cuda"):
    return make_shape_prior_factors(
        [], np.zeros((0, 3)), np.zeros((0, 3, 3)), capacity, dtype, device
    )


def empty_relative_pose_factors(capacity=1, dtype=np.float64, device="cuda"):
    return make_relative_pose_factors(
        [], [], np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros((0, 6, 6)),
        capacity, dtype, device,
    )


def empty_ltm_prior_factors(capacity=1, dtype=np.float64, device="cuda"):
    return make_ltm_prior_factors(
        [], np.zeros((0, 7)), np.zeros((0, 7, 7)), capacity, dtype, device
    )


def empty_param_prior_factors(capacity=1, dtype=np.float64, device="cuda"):
    return make_param_prior_factors([], [], [], [], [], capacity, dtype, device)


def empty_factor_tables(dtype=np.float64, device="cuda"):
    return FactorTables(
        reproj=empty_reprojection_factors(dtype=dtype, device=device),
        bbox=empty_bounding_box_factors(dtype=dtype, device=device),
        shape=empty_shape_prior_factors(dtype=dtype, device=device),
        relpose=empty_relative_pose_factors(dtype=dtype, device=device),
        ltm=empty_ltm_prior_factors(dtype=dtype, device=device),
        param_prior=empty_param_prior_factors(dtype=dtype, device=device),
    )


def make_camera_bundle(
    extrinsic_r, extrinsic_t, fx, fy, cx, cy, dtype=np.float64, device="cuda"
):
    """CameraBundle from extrinsics (camera pose in robot frame); stores the
    inverse (robot in camera frame)."""
    extrinsic_r = np.asarray(extrinsic_r, dtype=dtype)
    extrinsic_t = np.asarray(extrinsic_t, dtype=dtype)
    r_inv = np.swapaxes(extrinsic_r, -1, -2)
    t_inv = -np.einsum("...ij,...j->...i", r_inv, extrinsic_t)
    return CameraBundle(
        cam_from_robot_r=_t(r_inv, device),
        cam_from_robot_t=_t(t_inv, device),
        fx=_t(np.atleast_1d(fx).astype(dtype), device),
        fy=_t(np.atleast_1d(fy).astype(dtype), device),
        cx=_t(np.atleast_1d(cx).astype(dtype), device),
        cy=_t(np.atleast_1d(cy).astype(dtype), device),
    )
