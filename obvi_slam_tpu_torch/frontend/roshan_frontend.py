"""Roshan appearance-based bounding-box frontend (alternative associator).

Counterpart of ``obvi_slam_tpu/frontend/roshan_frontend.py``, the
reference's hue-saturation-histogram alternative to the default feature-based
associator (Roshan et al.-style object tracking):

  - per-detection context: normalized 2-D hue x saturation histogram of the
    bbox image patch (:149-176) + a single-view ellipsoid estimate
  - candidates: same semantic class (:254-287)
  - prune: centroid distance between the detection's single-view estimate and
    the candidate's estimate (pending: min over its observations'
    single-view estimates) within max_distance_for_associated_ellipsoids
    (:290-341)
  - score: MAX histogram correlation (cv::compareHist HISTCMP_CORREL —
    Pearson on bin counts) against the candidate's stored histograms
    (:341-371)

Images enter through an ``hsv_image_provider(frame_id, camera_id) ->
(H, W, 3) uint8/float HSV array`` callback (the provider abstracts
rosbag/png sources). Without a provider,
histograms are empty and association falls back to geometric pruning with
zero appearance scores.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch.frontend.bounding_box_frontend import (
    FeatureBasedBoundingBoxFrontEnd,
    single_view_ellipsoid_estimate,
)


@dataclass
class RoshanBbInfo:
    """Per-observation appearance payload (RoshanBbInfo)."""

    hue_sat_histogram: Optional[np.ndarray]  # (hue_bins, sat_bins), normalized
    single_bb_init_est: Optional[np.ndarray]  # (7,) single-view estimate
    detection_confidence: float


def hue_sat_histogram(hsv_patch, hue_bins=60, sat_bins=50, hue_range=180.0, sat_range=256.0):
    """cv::calcHist over H and S channels of the patch, L1-normalized."""
    if hsv_patch is None or hsv_patch.size == 0:
        return None
    h = np.asarray(hsv_patch[..., 0], dtype=np.float64).ravel()
    s = np.asarray(hsv_patch[..., 1], dtype=np.float64).ravel()
    hist, _, _ = np.histogram2d(
        h, s, bins=[hue_bins, sat_bins], range=[[0, hue_range], [0, sat_range]]
    )
    total = hist.sum()
    return hist / total if total > 0 else hist


def histogram_correlation(h1, h2) -> float:
    """cv::compareHist HISTCMP_CORREL: Pearson correlation over bins."""
    if h1 is None or h2 is None:
        return 0.0
    a = h1.ravel() - h1.mean()
    b = h2.ravel() - h2.mean()
    denom = np.sqrt((a @ a) * (b @ b))
    if denom < 1e-20:
        return 0.0
    return float(a @ b / denom)


class RoshanBbFrontEnd(FeatureBasedBoundingBoxFrontEnd):
    """Shares the template-method pipeline (filter -> associate -> pending ->
    mini-BA -> merge -> cleanup) with the feature-based frontend; overrides the
    context/prune/score hooks with the appearance-based versions."""

    def __init__(
        self,
        pg,
        roshan_params: dict,
        cov_gen_params: cfg.BoundingBoxCovGenParams,
        similarity_params: cfg.GeometricSimilarityScorerParams,
        img_heights_and_widths=None,
        hsv_image_provider: Optional[Callable] = None,
        ltm_front_end_data: Optional[Dict[int, dict]] = None,
        dtype=np.float64,
        device="cuda",
        plain: bool = False,
    ):
        # Map Roshan params onto the shared pipeline's association params
        # (min_observations / discard / confidence gates are shared concepts).
        assoc = cfg.FeatureBasedBbAssociationParams(
            min_observations_for_local_est=roshan_params.get(
                "min_observations_for_local_est", 3
            ),
            min_observations=roshan_params.get("min_observations", 40),
            discard_candidate_after_num_frames=roshan_params.get(
                "discard_candidate_after_num_frames", 40
            ),
            min_bb_confidence=roshan_params.get("min_bb_confidence", 0.3),
            required_min_conf_for_initialization=roshan_params.get(
                "required_min_conf_for_initialization", 0.5
            ),
        )
        super().__init__(
            pg,
            assoc,
            cov_gen_params,
            similarity_params,
            img_heights_and_widths,
            ltm_front_end_data,
            dtype,
            device,
            plain,
        )
        self.max_assoc_distance = roshan_params.get(
            "max_distance_for_associated_ellipsoids", 3.5
        )
        self.hue_bins = roshan_params.get("hue_histogram_bins", 60)
        self.sat_bins = roshan_params.get("saturation_histogram_bins", 50)
        self.hsv_image_provider = hsv_image_provider
        if hsv_image_provider is None:
            logging.getLogger(__name__).warning(
                "RoshanBbFrontEnd created without an hsv_image_provider: "
                "appearance histograms are empty, association degrades to "
                "geometric pruning with zero appearance scores"
            )

    # -- hooks ----------------------------------------------------------
    def _make_bb_context(self, frame_id, camera_id, bb, observed_features):
        hist = None
        if self.hsv_image_provider is not None:
            img = self.hsv_image_provider(frame_id, camera_id)
            if img is not None:
                x_min, x_max, y_min, y_max = (int(round(v)) for v in
                                              (bb.corners[0], bb.corners[1],
                                               bb.corners[2], bb.corners[3]))
                h, w = img.shape[:2]
                patch = img[
                    max(0, y_min) : min(h, y_max + 1),
                    max(0, x_min) : min(w, x_max + 1),
                ]
                hist = hue_sat_histogram(patch, self.hue_bins, self.sat_bins)
        est = single_view_ellipsoid_estimate(
            self.pg, frame_id, camera_id, bb.semantic_class, bb.corners
        )
        return RoshanBbInfo(hist, est, bb.detection_confidence)

    def _score_candidate_entries(self, frame_id, camera_id, bb, ctx: RoshanBbInfo):
        if ctx.single_bb_init_est is None:
            return []
        entries = []
        # Pending candidates.
        for pend_idx, pend in enumerate(self.pending):
            if pend.semantic_class != bb.semantic_class:
                continue
            infos = [
                info
                for cams in pend.observed_feats.values()
                for info in cams.values()
            ]
            dist = min(
                (
                    np.linalg.norm(ctx.single_bb_init_est[:3] - i.single_bb_init_est[:3])
                    for i in infos
                    if i.single_bb_init_est is not None
                ),
                default=np.inf,
            )
            if dist > self.max_assoc_distance:
                continue
            score = max(
                (histogram_correlation(ctx.hue_sat_histogram, i.hue_sat_histogram) for i in infos),
                default=0.0,
            )
            entries.append((("pending", pend_idx), score))
        # Initialized objects.
        for obj_id in self.objects_with_class(bb.semantic_class):
            obj_est = self.pg.objects[obj_id].ellipsoid
            dist = np.linalg.norm(ctx.single_bb_init_est[:3] - obj_est[:3])
            if dist > self.max_assoc_distance:
                continue
            infos = [
                info
                for cams in self.object_appearance.get(obj_id, {}).values()
                for info in cams.values()
                if isinstance(info, RoshanBbInfo)
            ]
            score = max(
                (histogram_correlation(ctx.hue_sat_histogram, i.hue_sat_histogram) for i in infos),
                default=0.0,
            )
            entries.append((("object", obj_id), score))
        return entries

    def get_front_end_obj_map_data(self):
        """Roshan LTM payload: per-object aggregate appearance (histograms
        serialized as lists for JSON)."""
        out = {}
        for obj_id, by_frame in self.object_appearance.items():
            infos = [
                {
                    "histogram": (
                        i.hue_sat_histogram.tolist()
                        if isinstance(i, RoshanBbInfo) and i.hue_sat_histogram is not None
                        else None
                    ),
                    "confidence": i.detection_confidence if isinstance(i, RoshanBbInfo) else 0.0,
                }
                for cams in by_frame.values()
                for i in cams.values()
                if isinstance(i, RoshanBbInfo)
            ]
            out[obj_id] = {"infos_for_observed_bbs": infos}
        return out
