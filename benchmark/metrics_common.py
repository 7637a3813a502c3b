"""Arithmetic the per-layer metric readers share: the idle share and device
time by kernel name from a traced window's summary (``harness.summarize``)."""

from __future__ import annotations

import re

# Kernel names of the Cholesky factorizations and triangular solves
# (torch.linalg's, through cuSOLVER and cuBLAS) and of cuBLAS's matrix
# products.
CHOL_TRSM = re.compile(r"potrf|trsm|trsv|cholesky", re.IGNORECASE)
GEMM = re.compile(r"gemm|syrk", re.IGNORECASE)


def idle_percent(record):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0


def ms_per_iteration(record, pattern):
    trace, n = record.get("trace"), record.get("traced_iterations")
    if not trace or not n:
        return None
    seconds = [s for name, (s, _) in trace["ops"].items() if pattern.search(name)]
    if not seconds:
        return None
    return sum(seconds) * 1e3 / n


def kernel_seconds_per_call(record, name_part, call_marker):
    """Device seconds of the kernels whose names hold ``name_part``, per
    record of the kernel named by ``call_marker`` (one per call)."""
    trace = record.get("trace")
    if not trace:
        return None
    total = sum(s for name, (s, _) in trace["ops"].items() if name_part in name)
    calls = sum(c for name, (_, c) in trace["ops"].items() if call_marker in name)
    if not calls or total <= 0:
        return None
    return total / calls
