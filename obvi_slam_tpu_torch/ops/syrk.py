"""Kernel K4: symmetric gram S = C^T C (``csrc/syrk.cu``).

Replaces the TPU kernel ``obvi_slam_tpu/ops/syrk_pallas.py::_kernel``
(wrapper ``syrk_lower_split`` plus the ``mirror_lower`` epilogue). One call
launches three device kernels: a panel mask per row of C, the row-compacted
products of each (lower tile pair, row split), and a fixed-order reduction of
the split partials that writes both triangles. ``plan`` gives the row splits
and the scratch shapes; the launcher sizes the grids and reports them in
``last_blocks``. On CPU tensors the wrapper runs the plain PyTorch version
(``c.T @ c``); on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from obvi_slam_tpu_torch.ops import _build

TILE = 64  # output tile edge = panel width in columns of C
CHUNK = 256  # rows of C per compaction round of a gram block
SPLIT_ROWS = 256  # rows of C per split, a multiple of CHUNK
MAX_PARTIALS = 4096  # cap on (tile pair, split) partial tiles

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {fn: [_I] * 5 + [_P] * 7 for fn in ("syrk_f32", "syrk_f64")}
GRIDS = ("syrk_kernel_mask", "syrk_kernel_gram", "syrk_kernel_reduce")

# Wrapper calls that launched the kernels since the last reset
# (ops.reset_kernel_launches); one per call.
launches = 0
# Blocks of each device kernel of the last call that launched, as the C
# launcher reported them (0: not launched).
last_blocks: dict = {}


class Plan(NamedTuple):
    tiles: int  # 64-column panels of C
    pairs: int  # lower tile pairs (ti >= tj)
    words: int  # 32-bit mask words per row (a bit per panel)
    split_rows: int
    splits: int


def plan(k_rows, m) -> Plan:
    """Row splits and scratch shapes of one call on C (k_rows, m)."""
    tiles = -(-m // TILE)
    pairs = tiles * (tiles + 1) // 2
    words = -(-tiles // 32)
    splits = min(-(-k_rows // SPLIT_ROWS), max(1, MAX_PARTIALS // max(pairs, 1)))
    split_rows = CHUNK * -(-k_rows // (CHUNK * splits)) if splits else SPLIT_ROWS
    splits = -(-k_rows // split_rows)
    return Plan(tiles, pairs, words, split_rows, splits)


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
    p = plan(k_rows, m)
    mask = torch.empty((k_rows, p.words), dtype=torch.int32, device=device)
    flags = torch.empty((p.pairs, p.splits), dtype=torch.int32, device=device)
    partials = torch.empty((p.pairs, p.splits, TILE, TILE), dtype=dtype, device=device)
    lib = _build.load("syrk", _ARGTYPES)
    fn = lib.syrk_f32 if dtype == torch.float32 else lib.syrk_f64
    blocks = (ctypes.c_int * len(GRIDS))()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            k_rows, m, p.words, p.split_rows, p.splits, c.data_ptr(), mask.data_ptr(),
            flags.data_ptr(), partials.data_ptr(), s.data_ptr(), stream, blocks,
        )
    if err != 0:
        raise RuntimeError(f"syrk kernel launch failed: cudaError {err}")
    launches += 1
    last_blocks.clear()
    last_blocks.update(zip(GRIDS, blocks))
    return s
