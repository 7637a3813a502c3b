"""Hand-written CUDA kernels for the H100 and their wrappers.

K1 ``reproj`` replaces ``obvi_slam_tpu/ops/reproj_pallas.py::_kernel``,
K2 ``bbox`` replaces ``obvi_slam_tpu/ops/bbox_pallas.py::_kernel``,
K3 ``band_gram`` replaces ``obvi_slam_tpu/ops/band_gram_pallas.py::_kernel``
and K4 ``syrk`` replaces ``obvi_slam_tpu/ops/syrk_pallas.py::_kernel``. Each
wrapper counts the launches of its kernel; a replayed CUDA graph adds the
launches that its capture recorded (``add_kernel_launches``).
"""

from obvi_slam_tpu_torch.ops import band_gram, bbox, reproj, syrk
from obvi_slam_tpu_torch.ops.band_gram import band_zbuild_gram  # noqa: F401
from obvi_slam_tpu_torch.ops.bbox import bbox_residuals_and_jac  # noqa: F401
from obvi_slam_tpu_torch.ops.reproj import reproj_residuals_and_jac  # noqa: F401
from obvi_slam_tpu_torch.ops.syrk import syrk_gram  # noqa: F401

_WRAPPERS = {"reproj": reproj, "bbox": bbox, "band_gram": band_gram, "syrk": syrk}


def kernel_launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_kernel_launches() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def add_kernel_launches(counts: dict) -> None:
    """Adds {kernel name: launches} to the counts (a graph's replay)."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n
