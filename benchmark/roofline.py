"""Operations, bytes and the least time of the port's kernels K1-K4, from
their operand shapes.

Counted as the kernel table of PERF.md counts them: every input byte read
once and every output byte written once, at the H100 SXM's 3.35 TB/s, and
the flops at its 67 TFLOP/s of float32 outside the tensor cores (NVIDIA's
data sheet, 700 W). A gram's flops are the lower triangle's products over
the rows' non-zeros, nnz (nnz + 1) per row, one multiply-add each; with no
count of non-zeros given, every slot of a row is taken as live.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
FLOPS_PER_FACTOR = {"reproj": 212, "bbox": 3360}
_I32, _BOOL = 4, 1  # bytes of an int32 index and of a bool mask

# K3's constants (ops/band_gram.py): a group's local pose window and z width.
K3_WIDTH = 128
K3_WBAND = 6 * K3_WIDTH


def bound_s(n_bytes: float, flops: float):
    """(least seconds, "bytes" or "operations")."""
    byte_s, flop_s = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (byte_s, "bytes") if byte_s >= flop_s else (flop_s, "operations")


def k1(n_rows, n_pose, n_point, n_cam, itemsize, n_live):
    """K1, reprojection residual and Jacobians: (bytes, flops)."""
    inputs = ((n_pose * 6 + n_point * 3 + n_cam * 12 + n_rows * 4) * itemsize
              + n_rows * 3 * _I32 + n_rows * _BOOL)
    outputs = n_rows * (2 + 12 + 6) * itemsize
    return inputs + outputs, FLOPS_PER_FACTOR["reproj"] * n_live


def k2(n_rows, n_obj, n_pose, n_cam, itemsize, n_live):
    """K2, bounding-box residual and Jacobians: (bytes, flops)."""
    inputs = ((n_obj * 7 + n_pose * 6 + n_cam * 12 + n_rows * 20) * itemsize
              + n_rows * 3 * _I32 + n_rows * _BOOL)
    outputs = n_rows * (4 + 28 + 24) * itemsize
    return inputs + outputs, FLOPS_PER_FACTOR["bbox"] * n_live


def k3(n_group, k_rows, n_slot, itemsize, live_slots=None):
    """K3, banded z build and group gram, on w_rows (G, K, 6C) and
    local_pose (G, K, C) int32, writing z (G, K, 768) and s (G, 768, 768):
    (bytes, flops). ``live_slots``: live slots of each z row (all, when
    None)."""
    inputs = n_group * k_rows * (6 * n_slot * itemsize + n_slot * _I32)
    outputs = (n_group * k_rows * K3_WBAND + n_group * K3_WBAND * K3_WBAND) * itemsize
    if live_slots is None:
        nnz = 6 * n_slot
        flops = n_group * k_rows * nnz * (nnz + 1)
    else:
        flops = sum(6 * s * (6 * s + 1) for s in live_slots)
    return inputs + outputs, flops


def k4(k_rows, m, itemsize, row_nnz=None):
    """K4, the lower-triangle gram c^T c of c (K, M): (bytes, flops)."""
    n_bytes = (k_rows * m + m * m) * itemsize
    if row_nnz is None:
        flops = k_rows * m * (m + 1)
    else:
        flops = sum(n * (n + 1) for n in row_nnz)
    return n_bytes, flops
