from obvi_slam_tpu_torch.solver.lm import (  # noqa: F401
    TERMINATION_NAMES,
    IterationRecord,
    LMParams,
    LMSummary,
)
from obvi_slam_tpu_torch.solver.lm_fused import (  # noqa: F401
    solve,
    solve_fused,
    solve_fused_jit,
    solve_two_phase,
    solve_two_phase_fused,
    solve_two_phase_jit,
)
from obvi_slam_tpu_torch.solver.plan import (  # noqa: F401
    SchurPlan,
    build_schur_plan,
    build_schur_plan_host,
)
from obvi_slam_tpu_torch.solver.schur import (  # noqa: F401
    FactorWeights,
    HuberParams,
    compute_step,
    ones_weights,
)
from obvi_slam_tpu_torch.solver.two_phase import (  # noqa: F401
    TwoPhaseAux,
    TwoPhaseConfig,
    reweight_on_device,
)
