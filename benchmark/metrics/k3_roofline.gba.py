"""K3's share of its roofline: the least time of one call at the operands'
shapes (``roofline.k3``: bytes at 3.35 TB/s or flops at 67 TFLOP/s) over
its device time per call (both device kernels of a call, counted by the
reduction kernel's records)."""

from benchmark import roofline
from benchmark.metrics_common import kernel_seconds_per_call


def read(record):
    shapes = record.get("k3")
    per_call = kernel_seconds_per_call(record, "band_gram_kernel", "band_gram_kernel_reduce")
    if shapes is None or per_call is None:
        return None
    n_group, k_rows, _, n_slot, itemsize = shapes
    least, _ = roofline.bound_s(*roofline.k3(n_group, k_rows, n_slot, itemsize))
    return least / per_call * 100.0
