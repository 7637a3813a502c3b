"""Kernel K1: reprojection residual + Jacobian (``csrc/reproj.cu``).

Replaces the TPU kernel ``obvi_slam_tpu/ops/reproj_pallas.py::_kernel``.
On CPU tensors the wrapper runs the plain PyTorch version
(``factors.reproj_fast.reproj_residuals_and_jac_fast``); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from obvi_slam_tpu_torch.factors.reproj_fast import (
    pose_rotation_tables,
    reproj_residuals_and_jac_fast,
)
from obvi_slam_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    fn: [_I, _I, _I, _I] + [_P] * 13 for fn in ("reproj_f32", "reproj_f64")
}

# Kernel launches since the last reset (ops.reset_kernel_launches).
launches = 0


def pose_table(poses):
    """(P, 21) per-pose rows [t | R^T | Jr], the kernels' pose gather table."""
    rt, jr = pose_rotation_tables(poses)
    n = poses.shape[0]
    return torch.cat([poses[:, 0:3], rt.reshape(n, 9), jr.reshape(n, 9)], 1).contiguous()


def camera_table(cams):
    """(C, 12) per-camera rows [C_r | C_t]."""
    n = cams.cam_from_robot_t.shape[0]
    return torch.cat(
        [cams.cam_from_robot_r.reshape(n, 9), cams.cam_from_robot_t], 1
    ).contiguous()


def reproj_residuals_and_jac(state, cams, f):
    """Returns (r (F,2), J_pose (F,2,6), J_point (F,2,3)); masked rows are 0."""
    device = state.poses.device
    if device.type == "cpu":
        return reproj_residuals_and_jac_fast(state, cams, f)
    if device.type != "cuda":
        raise ValueError(f"reproj kernel: unsupported device {device}")
    return launch(pose_table(state.poses), state.points, camera_table(cams), f)


def launch(pose_tab, points, cam_tab, f):
    """Launch K1 on prebuilt gather tables (``pose_table``, ``camera_table``)."""
    global launches
    device, dtype = points.device, points.dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"reproj kernel: {dtype} on {device} not supported")
    n = f.pose_idx.shape[0]
    n_pose, n_point, n_cam = pose_tab.shape[0], points.shape[0], cam_tab.shape[0]
    check = _build.check
    check(pose_tab, "pose_tab", device, dtype, (None, 21))
    check(points, "points", device, dtype, (None, 3))
    check(cam_tab, "cam_tab", device, dtype, (None, 12))
    for name in ("pose_idx", "point_idx", "cam_idx"):
        check(getattr(f, name), name, device, torch.int32, (n,))
    check(f.rect_obs, "rect_obs", device, dtype, (n, 2))
    check(f.multiplier, "multiplier", device, dtype, (n, 2))
    check(f.mask, "mask", device, torch.bool, (n,))
    if min(n_pose, n_point, n_cam) == 0:
        raise ValueError("reproj kernel: empty pose, point or camera table")

    r = torch.empty((n, 2), dtype=dtype, device=device)
    j_pose = torch.empty((n, 2, 6), dtype=dtype, device=device)
    j_point = torch.empty((n, 2, 3), dtype=dtype, device=device)
    if n == 0:
        return r, j_pose, j_point
    lib = _build.load("reproj", _ARGTYPES)
    fn = lib.reproj_f32 if dtype == torch.float32 else lib.reproj_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            n, n_pose, n_point, n_cam, pose_tab.data_ptr(), points.data_ptr(),
            cam_tab.data_ptr(), f.pose_idx.data_ptr(), f.point_idx.data_ptr(),
            f.cam_idx.data_ptr(), f.rect_obs.data_ptr(), f.multiplier.data_ptr(),
            f.mask.data_ptr(), r.data_ptr(), j_pose.data_ptr(), j_point.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"reproj kernel launch failed: cudaError {err}")
    launches += 1
    return r, j_pose, j_point
