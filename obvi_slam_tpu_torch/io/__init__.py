from obvi_slam_tpu_torch.io.readers import (  # noqa: F401
    read_bounding_boxes_by_node_id,
    read_camera_extrinsics,
    read_camera_intrinsics,
    read_orb_output_directory,
    read_poses_by_node_id,
    read_vslam_set,
)
from obvi_slam_tpu_torch.io.writers import (  # noqa: F401
    read_bb_association_results,
    write_bb_association_results,
    write_ellipsoid_results,
    write_robot_pose_results,
    write_visual_feature_results,
)
