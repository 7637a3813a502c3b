"""Kernel K4: symmetric gram S = C^T C (``csrc/syrk.cu``).

Replaces the TPU kernel ``obvi_slam_tpu/ops/syrk_pallas.py::_kernel``
(wrapper ``syrk_lower_split`` plus the ``mirror_lower`` epilogue): the
kernel computes the lower-triangle tiles and writes both triangles. On CPU
tensors the wrapper runs the plain PyTorch version (``c.T @ c``); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from obvi_slam_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {fn: [_I, _I, _P, _P, _P] for fn in ("syrk_f32", "syrk_f64")}

# Kernel launches since the last reset (ops.reset_kernel_launches).
launches = 0


def syrk_gram_plain(c):
    return c.T @ c


def syrk_gram(c):
    """c (K, M) -> c^T c (M, M), contracting over the leading dimension."""
    device = c.device
    if device.type == "cpu":
        return syrk_gram_plain(c)
    if device.type != "cuda":
        raise ValueError(f"syrk kernel: unsupported device {device}")
    return launch(c)


def launch(c):
    global launches
    device, dtype = c.device, c.dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"syrk kernel: {dtype} on {device} not supported")
    if c.dim() != 2:
        raise ValueError(f"syrk kernel: c has shape {tuple(c.shape)}, expected (K, M)")
    k_rows, m = c.shape
    _build.check(c, "c", device, dtype, (k_rows, m))
    s = torch.empty((m, m), dtype=dtype, device=device)
    if m == 0:
        return s
    lib = _build.load("syrk", _ARGTYPES)
    fn = lib.syrk_f32 if dtype == torch.float32 else lib.syrk_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(k_rows, m, c.data_ptr(), s.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"syrk kernel launch failed: cudaError {err}")
    launches += 1
    return s
