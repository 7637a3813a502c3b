from obvi_slam_tpu_torch.frontend.visual_features import VisualFeatureFrontend  # noqa: F401
from obvi_slam_tpu_torch.frontend.bounding_box_frontend import (  # noqa: F401
    FeatureBasedBoundingBoxFrontEnd,
    apply_merges,
    merge_objects_by_center_proximity,
)
from obvi_slam_tpu_torch.frontend.roshan_frontend import RoshanBbFrontEnd  # noqa: F401


def make_bb_frontend_hook(frontend):
    """Adapter: runner bb_frontend hook -> FeatureBasedBoundingBoxFrontEnd.

    Pulls the per-(frame, camera) detections and the observed feature pixels
    (the association context) from the problem data."""

    def hook(data, pg, frame_id):
        bbs_by_cam = data.bounding_boxes.get(frame_id, {})
        feats = data.features_for_frame(frame_id)
        for cam_id, bbs in bbs_by_cam.items():
            observed = {
                feat_id: cams[cam_id]
                for feat_id, cams in feats.items()
                if cam_id in cams
            }
            frontend.add_bounding_box_observations(frame_id, cam_id, bbs, observed)

    return hook

