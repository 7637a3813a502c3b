"""Kernel K1: reprojection residual + Jacobian (``csrc/reproj.cu``).

Replaces the TPU kernel ``obvi_slam_tpu/ops/reproj_pallas.py::_kernel``.
On CPU tensors the wrapper runs the plain PyTorch version
(``factors.reproj_fast.reproj_residuals_and_jac_fast``); on CUDA tensors it
launches the kernel, its only device work, or raises. The kernel reads the
raw poses and camera arrays and builds each factor's rotation itself.
"""

from __future__ import annotations

import ctypes

import torch

from obvi_slam_tpu_torch.factors.reproj_fast import reproj_residuals_and_jac_fast
from obvi_slam_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    fn: [_I, _I, _I, _I] + [_P] * 14 for fn in ("reproj_f32", "reproj_f64")
}
# Factors per block of csrc/reproj.cu (kThreads): one thread each.
THREADS = 64

# Kernel launches since the last reset (ops.reset_kernel_launches).
launches = 0


def reproj_residuals_and_jac(state, cams, f):
    """Returns (r (F,2), J_pose (F,2,6), J_point (F,2,3)); masked rows are 0."""
    device = state.poses.device
    if device.type == "cpu":
        return reproj_residuals_and_jac_fast(state, cams, f)
    if device.type != "cuda":
        raise ValueError(f"reproj kernel: unsupported device {device}")
    return launch(state.poses, state.points, cams.cam_from_robot_r, cams.cam_from_robot_t, f)


def launch(poses, points, cam_r, cam_t, f):
    """Launch K1 on the raw tables: poses (P, 6), points (M, 3), camera
    rotations (C, 3, 3) and translations (C, 3)."""
    global launches
    device, dtype = poses.device, poses.dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"reproj kernel: {dtype} on {device} not supported")
    n = f.pose_idx.shape[0]
    n_pose, n_point, n_cam = poses.shape[0], points.shape[0], cam_t.shape[0]
    check = _build.check
    check(poses, "poses", device, dtype, (None, 6))
    check(points, "points", device, dtype, (None, 3))
    check(cam_r, "cam_from_robot_r", device, dtype, (n_cam, 3, 3))
    check(cam_t, "cam_from_robot_t", device, dtype, (None, 3))
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
            n, n_pose, n_point, n_cam, poses.data_ptr(), points.data_ptr(),
            cam_r.data_ptr(), cam_t.data_ptr(), f.pose_idx.data_ptr(),
            f.point_idx.data_ptr(), f.cam_idx.data_ptr(), f.rect_obs.data_ptr(),
            f.multiplier.data_ptr(), f.mask.data_ptr(), r.data_ptr(),
            j_pose.data_ptr(), j_point.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"reproj kernel launch failed: cudaError {err}")
    launches += 1
    return r, j_pose, j_point
