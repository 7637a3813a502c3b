"""Kernel K2: bounding-box dual-quadric residual + Jacobian (``csrc/bbox.cu``).

Replaces the TPU kernel ``obvi_slam_tpu/ops/bbox_pallas.py::_kernel``.
On CPU tensors the wrapper runs the plain PyTorch version
(``factors.residuals.bbox_residuals_and_jac``); on CUDA tensors it launches
the kernel, its only device work, or raises. The kernel reads the raw poses
and camera arrays and builds each factor's rotation itself.
"""

from __future__ import annotations

import ctypes

import torch

from obvi_slam_tpu_torch.factors.residuals import bbox_residuals_and_jac as _plain
from obvi_slam_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    fn: [_I, _I, _I, _I, ctypes.c_double] + [_P] * 14
    for fn in ("bbox_f32", "bbox_f64")
}
# The lane map of csrc/bbox.cu: LANES lanes per factor (kLanes), lane k < 7
# takes column k of J_obj, lane 7 + m column m of J_pose, lane RESIDUAL_LANE
# the residual; FACTORS_PER_BLOCK factors per block (kFactorsPerBlock).
LANES = 16
RESIDUAL_LANE = 13
FACTORS_PER_BLOCK = 8

# Kernel launches since the last reset (ops.reset_kernel_launches).
launches = 0


def bbox_residuals_and_jac(state, cams, f, invalid_error=1e6):
    """Returns (r (B,4), J_obj (B,4,7), J_pose (B,4,6)); masked rows are 0,
    invalid projections give ``invalid_error`` and zero Jacobians."""
    device = state.poses.device
    if device.type == "cpu":
        return _plain(state, cams, f, invalid_error)
    if device.type != "cuda":
        raise ValueError(f"bbox kernel: unsupported device {device}")
    return launch(
        state.objects, state.poses, cams.cam_from_robot_r, cams.cam_from_robot_t, f,
        invalid_error,
    )


def launch(objects, poses, cam_r, cam_t, f, invalid_error=1e6):
    """Launch K2 on the raw tables: objects (K, 7), poses (P, 6), camera
    rotations (C, 3, 3) and translations (C, 3)."""
    global launches
    device, dtype = objects.device, objects.dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bbox kernel: {dtype} on {device} not supported")
    n = f.obj_idx.shape[0]
    n_obj, n_pose, n_cam = objects.shape[0], poses.shape[0], cam_t.shape[0]
    check = _build.check
    check(objects, "objects", device, dtype, (None, 7))
    check(poses, "poses", device, dtype, (None, 6))
    check(cam_r, "cam_from_robot_r", device, dtype, (n_cam, 3, 3))
    check(cam_t, "cam_from_robot_t", device, dtype, (None, 3))
    for name in ("obj_idx", "pose_idx", "cam_idx"):
        check(getattr(f, name), name, device, torch.int32, (n,))
    check(f.rect_corners, "rect_corners", device, dtype, (n, 4))
    check(f.sqrt_inf, "sqrt_inf", device, dtype, (n, 4, 4))
    check(f.mask, "mask", device, torch.bool, (n,))
    if min(n_obj, n_pose, n_cam) == 0:
        raise ValueError("bbox kernel: empty object, pose or camera table")

    r = torch.empty((n, 4), dtype=dtype, device=device)
    j_obj = torch.empty((n, 4, 7), dtype=dtype, device=device)
    j_pose = torch.empty((n, 4, 6), dtype=dtype, device=device)
    if n == 0:
        return r, j_obj, j_pose
    lib = _build.load("bbox", _ARGTYPES)
    fn = lib.bbox_f32 if dtype == torch.float32 else lib.bbox_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            n, n_obj, n_pose, n_cam, float(invalid_error), objects.data_ptr(),
            poses.data_ptr(), cam_r.data_ptr(), cam_t.data_ptr(), f.obj_idx.data_ptr(),
            f.pose_idx.data_ptr(), f.cam_idx.data_ptr(), f.rect_corners.data_ptr(),
            f.sqrt_inf.data_ptr(), f.mask.data_ptr(), r.data_ptr(),
            j_obj.data_ptr(), j_pose.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"bbox kernel launch failed: cudaError {err}")
    launches += 1
    return r, j_obj, j_pose
