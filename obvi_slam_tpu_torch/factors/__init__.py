from obvi_slam_tpu_torch.factors.reproj_fast import (  # noqa: F401
    pose_rotation_tables,
    reproj_residuals_and_jac_fast,
)
from obvi_slam_tpu_torch.factors.residuals import (  # noqa: F401
    all_residuals,
    bbox_residuals,
    bbox_residuals_and_jac,
    huber_rho,
    huber_sqrt_weight,
    ltm_residuals,
    ltm_residuals_and_jac,
    param_prior_residuals,
    relpose_residuals,
    relpose_residuals_and_jac,
    reproj_residuals,
    shape_residuals,
    shape_residuals_and_jac,
    total_cost,
)
