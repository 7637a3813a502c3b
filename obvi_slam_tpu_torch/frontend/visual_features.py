"""Visual-feature frontend: decides when pending feature tracks enter the
pose graph.

Faithful re-implementation of ``VisualFeatureFrontend``
(``visual_feature_front_end.h:214-802``):

  - new features accumulate in a pending cache until the min-parallax
    requirement holds between any two cached frames (pixel displacement and/or
    robot motion, :726-798)
  - once admitted, new observations are voted on with the normalized epipolar
    error against observations in the last N frames (:511-599); losers go to a
    secondary pending cache that is "cleaned" by majority voting (:644-697)
  - all pending features are flushed at global-BA frames (:420-450)
  - the initial 3-D estimate is adjusted by the delta between the initial and
    optimized pose of the first observing frame (:699-724)

This is host-side set logic over a handful of observations per frame — the
reference keeps it on CPU too; the device is reserved for the solves.

This module is a copy of ``obvi_slam_tpu/frontend/visual_features.py`` (numpy
only); the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from obvi_slam_tpu_torch.offline_data import OfflineProblemData
from obvi_slam_tpu_torch.pose_graph import PoseGraph


def _pose_to_rt(pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(pose[3:6]).as_matrix(), pose[:3]


def normalized_epipolar_error_vec(
    intrinsics1: np.ndarray,
    intrinsics2: np.ndarray,
    cam_to_robot_r1: np.ndarray,
    cam_to_robot_t1: np.ndarray,
    cam_to_robot_r2: np.ndarray,
    cam_to_robot_t2: np.ndarray,
    pixel1: np.ndarray,
    pixel2: np.ndarray,
    robot_pose1: np.ndarray,
    robot_pose2: np.ndarray,
) -> np.ndarray:
    """Epipolar-line projection error of pixel2 (visual_feature_front_end.h:50-133,
    adapted from IV_SLAM's CalculateEpipolarErrorVec)."""
    r1, t1 = _pose_to_rt(robot_pose1)
    r2, t2 = _pose_to_rt(robot_pose2)
    # cam1_to_cam2 = (T_w_r2 * T_r2_c2)^-1 * T_w_r1 * T_r1_c1
    rw1 = r1 @ cam_to_robot_r1
    tw1 = r1 @ cam_to_robot_t1 + t1
    rw2 = r2 @ cam_to_robot_r2
    tw2 = r2 @ cam_to_robot_t2 + t2
    r12 = rw2.T @ rw1
    t12 = rw2.T @ (tw1 - tw2)

    h_epipole = intrinsics2 @ t12
    if abs(h_epipole[2]) < 1e-12:
        return np.array([np.inf, np.inf])
    epipole = h_epipole[:2] / h_epipole[2]

    x1h = np.linalg.inv(intrinsics1) @ np.array([pixel1[0], pixel1[1], 1.0])
    h_x1_in2 = intrinsics2 @ (r12 @ x1h + t12)
    if abs(h_x1_in2[2]) < 1e-12:
        return np.array([np.inf, np.inf])
    x1_in2 = h_x1_in2[:2] / h_x1_in2[2]

    diff = x1_in2 - epipole
    n = np.linalg.norm(diff)
    if n < 1e-12:
        return np.array([np.inf, np.inf])
    u_hat = diff / n
    proj = epipole + np.dot(pixel2 - epipole, u_hat) * u_hat
    return proj - pixel2


class _CachedInfo:
    """VisualFeatureCachedInfo (visual_feature_front_end.h:168-210)."""

    def __init__(self):
        self.is_cache_cleaned = False
        # frame_id -> list of (cam_id, pixel, std_dev)
        self.factors_by_frame: Dict[int, List[Tuple[int, np.ndarray, float]]] = {}
        self.pose_by_frame: Dict[int, Optional[np.ndarray]] = {}

    def add(self, frame_id, factors, pose):
        self.factors_by_frame[frame_id] = list(factors)
        self.pose_by_frame[frame_id] = pose

    def min_frame_id(self):
        return min(self.factors_by_frame)

    def ordered_frames_geq(self, min_frame):
        return sorted(f for f in self.factors_by_frame if f >= min_frame)


class VisualFeatureFrontend:
    def __init__(
        self,
        gba_checker,
        reprojection_error_provider,
        min_parallax_pixel=5.0,
        min_parallax_transl=0.1,
        min_parallax_orient=0.05,
        enforce_pixel_parallax=True,
        enforce_pose_parallax=False,
        inlier_epipolar_err_thresh=8.0,
        check_past_n_frames=5,
        enforce_epipolar=True,
        early_votes_return=True,
        inlier_majority_percentage=0.5,
    ):
        self.gba_checker = gba_checker
        self.reprojection_error_provider = reprojection_error_provider
        self.min_parallax_pixel = min_parallax_pixel
        self.min_parallax_transl = min_parallax_transl
        self.min_parallax_orient = min_parallax_orient
        self.enforce_pixel_parallax = enforce_pixel_parallax
        self.enforce_pose_parallax = enforce_pose_parallax
        self.inlier_epipolar_err_thresh = inlier_epipolar_err_thresh
        self.check_past_n_frames = check_past_n_frames
        self.enforce_epipolar = enforce_epipolar
        self.early_votes_return = early_votes_return
        self.inlier_majority_percentage = inlier_majority_percentage

        self.added_feature_ids = set()
        self.pending: Dict[int, _CachedInfo] = {}
        self.pending_initialized: Dict[int, _CachedInfo] = {}

    # ------------------------------------------------------------------
    def add_visual_feature_observations(
        self,
        data: OfflineProblemData,
        pg: PoseGraph,
        min_frame_id: int,
        max_frame_id: int,
    ):
        feats = data.features_for_frame(max_frame_id)
        init_pose = data.get_robot_pose_estimate(max_frame_id)

        for feature_id, cams_and_pixels in feats.items():
            factors = []
            for cam_id, pixel in cams_and_pixels.items():
                std_dev = self.reprojection_error_provider(
                    data, pg, max_frame_id, feature_id, cam_id
                )
                factors.append((cam_id, np.asarray(pixel, dtype=np.float64), std_dev))

            in_graph = feature_id in self.added_feature_ids
            in_init_cache = feature_id in self.pending_initialized

            if in_init_cache:
                cache = self.pending_initialized[feature_id]
                self._add_to_cache(
                    data, pg, max_frame_id, factors, init_pose, cache, self.enforce_epipolar
                )
                if cache.is_cache_cleaned:
                    for fr in sorted(cache.factors_by_frame):
                        for cam_id, pixel, std in cache.factors_by_frame[fr]:
                            pg.add_visual_factor(fr, cam_id, feature_id, pixel, std)
                del self.pending_initialized[feature_id]
            elif in_graph:
                for cam_id, pixel, std in factors:
                    verdict, found_refs = self._is_inlier_in_pose_graph(
                        data, pg, feature_id, max_frame_id, cam_id, pixel
                    )
                    if verdict:
                        pg.add_visual_factor(max_frame_id, cam_id, feature_id, pixel, std)
                    elif not found_refs:
                        # No recent references -> secondary pending cache.
                        cache = self.pending_initialized.setdefault(
                            feature_id, _CachedInfo()
                        )
                        self._add_to_cache(
                            data, pg, max_frame_id, factors, init_pose, cache, self.enforce_epipolar
                        )
            else:
                cache = self.pending.setdefault(feature_id, _CachedInfo())
                self._add_to_cache(
                    data, pg, max_frame_id, factors, init_pose, cache, self.enforce_epipolar
                )
                if self._check_min_parallax(min_frame_id, cache):
                    self._admit_feature(data, pg, feature_id, cache)

        # Flush all pending at global-BA frames.
        if self.gba_checker(max_frame_id):
            to_admit = []
            for feature_id, cache in self.pending.items():
                if self._check_min_parallax(min_frame_id, cache):
                    to_admit.append(feature_id)
            for feature_id in to_admit:
                self._admit_feature(data, pg, feature_id, self.pending[feature_id])

    # ------------------------------------------------------------------
    def _admit_feature(self, data, pg, feature_id, cache):
        pos = self._initial_feature_position(
            data, pg, feature_id, data.feature_init_positions[feature_id], cache
        )
        pg.add_feature(feature_id, pos)
        for fr in sorted(cache.factors_by_frame):
            for cam_id, pixel, std in cache.factors_by_frame[fr]:
                pg.add_visual_factor(fr, cam_id, feature_id, pixel, std)
        del self.pending[feature_id]
        self.added_feature_ids.add(feature_id)

    def _initial_feature_position(self, data, pg, feature_id, unadjusted, cache):
        """getInitialFeaturePosition_ (:699-724): re-anchor the initial 3-D
        estimate to the optimized pose of the first observing frame."""
        first_frame = cache.min_frame_id()
        init_first = data.get_robot_pose_estimate(first_frame)
        optim_first = pg.get_robot_pose(first_frame)
        if init_first is None or optim_first is None:
            return np.asarray(unadjusted, dtype=np.float64)
        r0, t0 = _pose_to_rt(init_first)
        rel = r0.T @ (np.asarray(unadjusted) - t0)
        r1, t1 = _pose_to_rt(optim_first)
        return r1 @ rel + t1

    def _check_min_parallax(self, min_frame_id, cache: _CachedInfo) -> bool:
        frames = cache.ordered_frames_geq(min_frame_id)
        if len(frames) <= 1:
            return False
        for i in range(len(frames) - 1):
            f1 = frames[i]
            pose1 = cache.pose_by_frame.get(f1)
            pix1 = {c: p for c, p, _ in cache.factors_by_frame[f1]}
            for j in range(i + 1, len(frames)):
                f2 = frames[j]
                pose2 = cache.pose_by_frame.get(f2)
                pix2 = {c: p for c, p, _ in cache.factors_by_frame[f2]}
                pose_ok = False
                if self.enforce_pose_parallax and pose1 is not None and pose2 is not None:
                    r1, t1 = _pose_to_rt(pose1)
                    r2, t2 = _pose_to_rt(pose2)
                    rel_t = r1.T @ (t2 - t1)
                    rel_r = r1.T @ r2
                    angle = np.linalg.norm(
                        np.array(
                            [
                                rel_r[2, 1] - rel_r[1, 2],
                                rel_r[0, 2] - rel_r[2, 0],
                                rel_r[1, 0] - rel_r[0, 1],
                            ]
                        )
                    )
                    # |axis*2sin(theta)| ~ angle for this check; use arccos form
                    cos_a = np.clip((np.trace(rel_r) - 1) / 2, -1, 1)
                    angle = np.arccos(cos_a)
                    if (
                        np.linalg.norm(rel_t) >= self.min_parallax_transl
                        or angle >= self.min_parallax_orient
                    ):
                        pose_ok = True
                pixel_ok = False
                if self.enforce_pixel_parallax:
                    for p1 in pix1.values():
                        for p2 in pix2.values():
                            if np.linalg.norm(p1 - p2) >= self.min_parallax_pixel:
                                pixel_ok = True
                if self.enforce_pose_parallax and not self.enforce_pixel_parallax:
                    ok = pose_ok
                elif self.enforce_pixel_parallax and not self.enforce_pose_parallax:
                    ok = pixel_ok
                elif self.enforce_pose_parallax and self.enforce_pixel_parallax:
                    ok = pose_ok and pixel_ok
                else:
                    ok = True
                if ok:
                    return True
        return False

    # ------------------------------------------------------------------
    def _epipolar_inlier_vote(
        self, data, pg, cand_frame, cand_cam, cand_pixel, refs_by_frame
    ) -> bool:
        """isReprojectionErrorFactorInlier (:511-599). ``refs_by_frame``:
        ordered dict frame -> [(cam_id, pixel)]."""
        cand_pose = data.get_robot_pose_estimate(cand_frame)
        if cand_pose is None:
            return False
        cam2 = pg.cameras[cand_cam]
        votes = 0
        n_voters = 0
        for fr in sorted(refs_by_frame):
            for ref_cam, ref_pixel in refs_by_frame[fr]:
                if fr == cand_frame and ref_cam == cand_cam:
                    continue
                ref_pose = data.get_robot_pose_estimate(fr)
                if ref_pose is None:
                    return False
                cam1 = pg.cameras[ref_cam]
                err = normalized_epipolar_error_vec(
                    cam1.intrinsics,
                    cam2.intrinsics,
                    cam1.extrinsics_r,
                    cam1.extrinsics_t,
                    cam2.extrinsics_r,
                    cam2.extrinsics_t,
                    ref_pixel,
                    cand_pixel,
                    ref_pose,
                    cand_pose,
                )
                if np.linalg.norm(err) < self.inlier_epipolar_err_thresh:
                    votes += 1
                n_voters += 1
            # Reference quirk: early_votes_return returns after the FIRST
            # frame group (visual_feature_front_end.h:594-596).
            if self.early_votes_return and n_voters > 0:
                return votes / n_voters > self.inlier_majority_percentage
        if n_voters == 0:
            return False
        return votes / n_voters > self.inlier_majority_percentage

    def _is_inlier_in_pose_graph(
        self, data, pg, feature_id, cand_frame, cand_cam, cand_pixel
    ):
        """Returns (is_inlier, found_references)."""
        min_frame = cand_frame - self.check_past_n_frames
        refs_by_frame: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for fid in pg.visual_factors_by_feature.get(feature_id, []):
            f = pg.visual_factors[fid]
            if f.frame_id > min_frame:
                refs_by_frame.setdefault(f.frame_id, []).append((f.camera_id, f.pixel))
        if not refs_by_frame:
            return False, False
        return (
            self._epipolar_inlier_vote(
                data, pg, cand_frame, cand_cam, cand_pixel, refs_by_frame
            ),
            True,
        )

    def _is_inlier_in_cache(self, data, pg, cand_frame, cand_cam, cand_pixel, cache):
        refs_by_frame = {
            fr: [(c, p) for c, p, _ in lst]
            for fr, lst in cache.factors_by_frame.items()
        }
        return self._epipolar_inlier_vote(
            data, pg, cand_frame, cand_cam, cand_pixel, refs_by_frame
        )

    def _add_to_cache(
        self, data, pg, frame_id, factors, pose, cache: _CachedInfo, use_epipolar
    ):
        """addFactorsAndRobotPoseToCache_ (:644-697)."""
        if not use_epipolar:
            cache.add(frame_id, factors, pose)
            return
        if cache.is_cache_cleaned:
            keep = [
                f
                for f in factors
                if self._is_inlier_in_cache(data, pg, frame_id, f[0], f[1], cache)
            ]
            if keep:
                cache.add(frame_id, keep, pose)
        else:
            cache.add(frame_id, factors, pose)
            cleaned: Dict[int, List] = {}
            for fr, lst in cache.factors_by_frame.items():
                for cam_id, pixel, std in lst:
                    if self._is_inlier_in_cache(data, pg, fr, cam_id, pixel, cache):
                        cleaned.setdefault(fr, []).append((cam_id, pixel, std))
            if cleaned:
                cache.factors_by_frame = cleaned
                cache.pose_by_frame = {
                    fr: cache.pose_by_frame.get(fr) for fr in cleaned
                }
                cache.is_cache_cleaned = True
