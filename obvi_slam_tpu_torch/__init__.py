"""obvi_slam_tpu_torch: the object-visual bundle adjustment of
``obvi_slam_tpu`` in PyTorch, with hand-written CUDA kernels for the H100.

Layout (each module keeps the name of its counterpart in ``obvi_slam_tpu``):

  - ``types``, ``geometry``      tables, state and SO(3)/dual-quadric math;
  - ``factors``                  the five residual families; the plain
                                 versions of kernels K1 (reprojection) and K2
                                 (bounding box);
  - ``ops``                      K1 and K2 in CUDA C++ (``ops/csrc``), built
                                 with nvcc on first use, with launch counters;
  - ``solver``                   the host Schur plan, ``compute_step`` on the
                                 dense slot-gram path, LM and the two-phase
                                 window solve;
  - ``synthetic``, ``convert``   test problems and state exchange with the
                                 reference package.

Entry points take ``device`` (default ``"cuda"``); on CPU tensors every
kernel wrapper runs its plain PyTorch version. This package imports torch and
numpy only.
"""

from obvi_slam_tpu_torch import factors, geometry, ops, solver, types  # noqa: F401
from obvi_slam_tpu_torch.ops import kernel_launches, reset_kernel_launches  # noqa: F401
from obvi_slam_tpu_torch.solver import (  # noqa: F401
    LMParams,
    TwoPhaseAux,
    TwoPhaseConfig,
    compute_step,
    solve,
    solve_two_phase,
)
from obvi_slam_tpu_torch.synthetic import synthetic_problem  # noqa: F401
