"""obvi_slam_tpu_torch: the object-visual bundle adjustment of
``obvi_slam_tpu`` in PyTorch, with hand-written CUDA kernels for the H100.

Layout (each module keeps the name of its counterpart in ``obvi_slam_tpu``):

  - ``types``, ``geometry``      tables, state and SO(3)/dual-quadric math;
  - ``factors``                  the five residual families; the plain
                                 versions of kernels K1 (reprojection) and K2
                                 (bounding box);
  - ``ops``                      K1-K4 in CUDA C++ (``ops/csrc``), built
                                 with nvcc on first use, with launch counters;
                                 K3 (banded gram) and K4 (syrk gram) hold their
                                 plain versions beside their wrappers;
  - ``solver``                   the host Schur plan with the band layouts,
                                 ``compute_step`` on the dense and banded
                                 slot-gram paths, the block-tridiagonal +
                                 Woodbury band solve (``band_solve``), LM, the
                                 two-phase solve, and the window problem
                                 builder (``problem``);
  - ``config``, ``pose_graph``,  the session: the reference's JSON config,
    ``offline_data``, ``timing``, the host pose graph, the input bundle, the
    ``frontend``, ``runner``,    phase timers, the visual-feature and
    ``pgo``                      bounding-box frontends (the pending-object
                                 mini-BA), ``OfflineProblemRunner`` and its
                                 PGO pass on global-BA frames;
  - ``ltm``, ``ltm_pairwise``    the long-term object map: marginal
                                 covariances, repair, JSON, next-session
                                 seeding;
  - ``synthetic``, ``convert``   test problems and sessions, and state
                                 exchange with the reference package.

Entry points take ``device`` (default ``"cuda"``); on CPU tensors every
kernel wrapper runs its plain PyTorch version. This package imports torch and
numpy only.
"""

from obvi_slam_tpu_torch import config, factors, geometry, ops, solver, types  # noqa: F401
from obvi_slam_tpu_torch.ops import kernel_launches, reset_kernel_launches  # noqa: F401
from obvi_slam_tpu_torch.pose_graph import PoseGraph  # noqa: F401
from obvi_slam_tpu_torch.runner import OfflineProblemRunner  # noqa: F401
from obvi_slam_tpu_torch.solver import (  # noqa: F401
    LMParams,
    TwoPhaseAux,
    TwoPhaseConfig,
    compute_step,
    solve,
    solve_two_phase,
)
from obvi_slam_tpu_torch.synthetic import (  # noqa: F401
    synthetic_object_session,
    synthetic_problem,
    synthetic_session,
)
from obvi_slam_tpu_torch.frontend import (  # noqa: F401
    FeatureBasedBoundingBoxFrontEnd,
    VisualFeatureFrontend,
    apply_merges,
    make_bb_frontend_hook,
    merge_objects_by_center_proximity,
)
from obvi_slam_tpu_torch.ltm import (  # noqa: F401
    LongTermObjectMap,
    extract_long_term_object_map,
    seed_pose_graph_from_ltm,
)
