"""Hand-written CUDA kernels for the H100 and their wrappers.

K1 ``reproj`` replaces ``obvi_slam_tpu/ops/reproj_pallas.py::_kernel`` and
K2 ``bbox`` replaces ``obvi_slam_tpu/ops/bbox_pallas.py::_kernel``. Each
wrapper counts the launches of its kernel.
"""

from obvi_slam_tpu_torch.ops import bbox, reproj
from obvi_slam_tpu_torch.ops.bbox import bbox_residuals_and_jac  # noqa: F401
from obvi_slam_tpu_torch.ops.reproj import reproj_residuals_and_jac  # noqa: F401

_WRAPPERS = {"reproj": reproj, "bbox": bbox}


def kernel_launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_kernel_launches() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0
