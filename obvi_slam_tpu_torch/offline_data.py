"""Immutable per-session input bundle (OfflineProblemData analog,
``include/refactoring/offline/offline_problem_data.h``).

This module is a copy of ``obvi_slam_tpu/offline_data.py`` (numpy
only); the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from obvi_slam_tpu_torch.pose_graph import CameraInfo


@dataclass
class RawBoundingBox:
    """RawBoundingBox (vslam_obj_opt_types_refactor.h:85-102)."""

    corners: np.ndarray  # (4,) [x_min, x_max, y_min, y_max] pixels
    semantic_class: str
    detection_confidence: float


@dataclass
class OfflineProblemData:
    """All inputs for one session.

    - ``feature_tracks``: feat_id -> frame_id -> cam_id -> pixel (2,)
      (StructuredVisionFeatureTrack, offline_problem_data.h:24-100)
    - ``feature_init_positions``: feat_id -> (3,) initial world estimate
      (from ORB depth unprojection)
    - ``initial_poses``: frame_id -> (6,) initial trajectory
    - ``bounding_boxes``: frame_id -> cam_id -> [RawBoundingBox]
    """

    cameras: Dict[int, CameraInfo]
    feature_tracks: Dict[int, Dict[int, Dict[int, np.ndarray]]]
    feature_init_positions: Dict[int, np.ndarray]
    initial_poses: Dict[int, np.ndarray]
    bounding_boxes: Dict[int, Dict[int, List[RawBoundingBox]]] = field(
        default_factory=dict
    )
    # feat_id -> frame_id -> cam_id -> descriptor-free "ORB feature present in
    # image region" info is not needed: the feature-based bb frontend uses the
    # feature *pixels* per frame, which feature_tracks already provides.

    _tracks_by_frame: Optional[Dict[int, Dict[int, Dict[int, np.ndarray]]]] = None

    def max_frame_id(self) -> int:
        return max(self.initial_poses)

    def get_robot_pose_estimate(self, frame_id) -> Optional[np.ndarray]:
        return self.initial_poses.get(frame_id)

    def features_for_frame(self, frame_id) -> Dict[int, Dict[int, np.ndarray]]:
        """feat_id -> cam_id -> pixel for features observed at frame_id."""
        if self._tracks_by_frame is None:
            by_frame: Dict[int, Dict[int, Dict[int, np.ndarray]]] = {}
            for feat_id, track in self.feature_tracks.items():
                for fr, cams in track.items():
                    by_frame.setdefault(fr, {})[feat_id] = cams
            object.__setattr__(self, "_tracks_by_frame", by_frame)
        return self._tracks_by_frame.get(frame_id, {})
