"""Kernel K3: banded z build + group gram (``csrc/band_gram.cu``).

Replaces the TPU kernel ``obvi_slam_tpu/ops/band_gram_pallas.py::_kernel``,
with the layouts of its wrapper ``band_zbuild_gram``. On CPU tensors the
wrapper runs the plain PyTorch version (``band_zbuild_gram_plain``, the
one-hot contraction and batched gram of the reference's XLA band branch);
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from obvi_slam_tpu_torch.ops import _build

WIDTH = 128  # local pose window (2 * plan.BAND_TP)
WBAND = 6 * WIDTH

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    fn: [_I, _I, _I] + [_P] * 5 for fn in ("band_gram_f32", "band_gram_f64")
}

# Kernel launches since the last reset (ops.reset_kernel_launches).
launches = 0


def band_zbuild_gram_plain(w_rows, local_pose):
    """z[g, k, c*128 + p] = sum_s [local_pose[g, k, s] == p] w_rows[g, k, 6s + c]
    and s = z^T z per group, as a one-hot contraction and a batched gram."""
    n_group, k_rows, c6 = w_rows.shape
    width = torch.arange(WIDTH, dtype=local_pose.dtype, device=local_pose.device)
    onehot = (local_pose[..., None] == width).to(w_rows.dtype)  # (G, K, C, 128)
    w_ct = w_rows.reshape(n_group, k_rows, c6 // 6, 6).transpose(-1, -2)  # (G, K, 6, C)
    z = torch.matmul(w_ct, onehot).reshape(n_group, k_rows, WBAND)
    return z, torch.bmm(z.transpose(1, 2), z)


def band_zbuild_gram(w_rows, local_pose):
    """w_rows (G, K, 6C) float, local_pose (G, K, C) int32 in [0, 128) with
    128 marking a dead slot. Returns (z (G, K, 768), s (G, 768, 768)): z's
    rows are (landmark, block column), its columns (component, local pose);
    s = z^T z per group in the same c-major order."""
    device = w_rows.device
    if device.type == "cpu":
        return band_zbuild_gram_plain(w_rows, local_pose)
    if device.type != "cuda":
        raise ValueError(f"band_gram kernel: unsupported device {device}")
    return launch(w_rows, local_pose)


def launch(w_rows, local_pose):
    global launches
    device, dtype = w_rows.device, w_rows.dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"band_gram kernel: {dtype} on {device} not supported")
    n_group, k_rows, c6 = w_rows.shape
    if c6 % 6:
        raise ValueError(f"band_gram kernel: w_rows width {c6} is not 6 per slot")
    _build.check(w_rows, "w_rows", device, dtype, (n_group, k_rows, c6))
    _build.check(local_pose, "local_pose", device, torch.int32, (n_group, k_rows, c6 // 6))
    z = torch.empty((n_group, k_rows, WBAND), dtype=dtype, device=device)
    s = torch.empty((n_group, WBAND, WBAND), dtype=dtype, device=device)
    if n_group == 0:
        return z, s
    lib = _build.load("band_gram", _ARGTYPES)
    fn = lib.band_gram_f32 if dtype == torch.float32 else lib.band_gram_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            n_group, k_rows, c6 // 6, w_rows.data_ptr(), local_pose.data_ptr(),
            z.data_ptr(), s.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"band_gram kernel launch failed: cudaError {err}")
    launches += 1
    return z, s
