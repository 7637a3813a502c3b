from obvi_slam_tpu_torch.metrics.trajectory import (  # noqa: F401
    ATEResults,
    align_with_ground_truth,
    ate_for_synced_aligned,
    combine_ate_results,
    distribution_stats,
    find_alignment_transformation,
    rpe_for_synced_aligned,
    waypoint_consistency,
)
from obvi_slam_tpu_torch.metrics.objects import (  # noqa: F401
    associate_objects,
    ellipsoid_aabb,
    iou_for_object_set,
    object_metrics,
)
