"""Host-side pose-graph state store.

Replaces the reference's pointer-based node/factor registries
(``low_level_feature_pose_graph.h`` / ``object_pose_graph.h``) with a plain
Python + numpy store. The device never sees this structure: windows are
gathered into padded ``FactorTables`` by ``solver.problem`` and written back
after each solve.

Conventions kept from the reference:
  - frame ids are contiguous uint64-ish ints starting at 0
  - factor ids are (factor_type, index) pairs; factor type codes match
    low_level_feature_pose_graph.h:18-23 / object_pose_graph.h:18-20
  - ``addNewEllipsoid`` auto-adds the semantic-class shape prior
    (object_pose_graph.h:354-397)
  - ``mergeObjects`` re-points observation factors and removes the merged
    object (object_pose_graph.h mergeObjects region)
  - value snapshots support the two-phase revert and jump reversion
    (makeCopyDeepCopyValues / setValuesFromAnotherPoseGraph)

This module is a copy of ``obvi_slam_tpu/pose_graph.py`` (numpy
only); the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

# Factor type ids (low_level_feature_pose_graph.h:18-23, object_pose_graph.h:18-20).
REPROJECTION_FACTOR = 0
PAIRWISE_FEATURE_FACTOR = 1
OBJECT_OBSERVATION_FACTOR = 2
SHAPE_PRIOR_FACTOR = 3
LTM_FACTOR = 4
RELATIVE_POSE_FACTOR = 5


@dataclass
class VisualFactor:
    """ReprojectionErrorFactor (low_level_feature_pose_graph.h:91-126)."""

    frame_id: int
    camera_id: int
    feature_id: int
    pixel: np.ndarray  # (2,)
    reprojection_error_std_dev: float


@dataclass
class RelPoseFactor:
    """RelPoseFactor (low_level_feature_pose_graph.h:128-160)."""

    before_frame: int
    after_frame: int
    rel_pose: np.ndarray  # (6,) [t, axis-angle]
    covariance: np.ndarray  # (6, 6)


@dataclass
class ObjectObservationFactor:
    """ObjectObservationFactor (object_pose_graph.h:89-125)."""

    frame_id: int
    camera_id: int
    object_id: int
    corners: np.ndarray  # (4,) [x_min, x_max, y_min, y_max] pixels
    covariance: np.ndarray  # (4, 4)


@dataclass
class ShapePriorFactorEntry:
    """ShapeDimPriorFactor (object_pose_graph.h:127-147)."""

    object_id: int
    mean: np.ndarray  # (3,)
    covariance: np.ndarray  # (3, 3)


@dataclass
class LtmFactorEntry:
    """One unary LTM prior (independent_object_map_factor.h)."""

    object_id: int
    mean: np.ndarray  # (7,)
    covariance: np.ndarray  # (7, 7)


@dataclass
class EllipsoidNode:
    """EllipsoidEstimateNode (object_pose_graph.h:22-87)."""

    ellipsoid: np.ndarray  # (7,)
    semantic_class: str


@dataclass
class CameraInfo:
    intrinsics: np.ndarray  # (3, 3)
    extrinsics_r: np.ndarray  # (3, 3) camera orientation in robot frame
    extrinsics_t: np.ndarray  # (3,)


def batched_sqrt_inf(covs: np.ndarray) -> np.ndarray:
    """cov^-1 principal square root for a batch of symmetric PD matrices —
    Eigen ``cov.inverse().sqrt()`` semantics (what every factor's whitening
    uses) via one batched eigendecomposition instead of per-matrix
    scipy.sqrtm calls."""
    covs = np.asarray(covs, dtype=np.float64)
    if covs.size == 0:
        return covs
    w, v = np.linalg.eigh(covs)
    if np.any(w <= 0):
        bad = np.nonzero(np.any(w <= 0, axis=-1))[0]
        raise np.linalg.LinAlgError(
            f"singular/indefinite covariance at batch rows {bad[:10].tolist()} "
            f"(min eigenvalue {w.min():.3e})"
        )
    return np.einsum("...ij,...j,...kj->...ik", v, 1.0 / np.sqrt(w), v)


class PoseGraph:
    """ObjectAndReprojectionFeaturePoseGraph equivalent."""

    def __init__(
        self,
        cameras: Dict[int, CameraInfo],
        shape_mean_and_cov_by_class: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    ):
        self.cameras = cameras
        self.shape_mean_and_cov_by_class = shape_mean_and_cov_by_class or {}

        self.robot_poses: Dict[int, np.ndarray] = {}
        self.features: Dict[int, np.ndarray] = {}
        self.first_frame_for_feature: Dict[int, int] = {}

        self.visual_factors: List[VisualFactor] = []
        self.visual_factors_by_frame: Dict[int, List[int]] = defaultdict(list)
        self.visual_factors_by_feature: Dict[int, List[int]] = defaultdict(list)

        self.relpose_factors: List[RelPoseFactor] = []
        self.relpose_factors_by_frame: Dict[int, List[int]] = defaultdict(list)

        self.objects: Dict[int, EllipsoidNode] = {}
        self.object_observations: List[ObjectObservationFactor] = []
        self.obj_obs_by_frame: Dict[int, List[int]] = defaultdict(list)
        self.obj_obs_by_object: Dict[int, List[int]] = defaultdict(list)
        self.shape_priors: List[ShapePriorFactorEntry] = []
        self.shape_priors_by_object: Dict[int, List[int]] = defaultdict(list)
        self.ltm_factors: List[LtmFactorEntry] = []
        self.ltm_factors_by_object: Dict[int, List[int]] = defaultdict(list)
        self.ltm_object_ids: Set[int] = set()

        self._next_object_id = 0
        # Tombstones from merges: old id -> surviving id.
        self.merged_objects: Dict[int, int] = {}

        # Columnar factor mirrors (struct-of-arrays) for the window builder:
        # factor stores are append-only (object merges only re-point
        # object_id, handled in merge_objects), so the arrays are extended
        # incrementally — build_problem's gathering and inclusion rules then
        # run as numpy vector ops instead of per-factor Python loops (the
        # host-side hot path of the window builder).
        self._vf_cols: Dict[str, np.ndarray] = {}
        self._vf_cols_len = 0
        self._oo_cols: Dict[str, np.ndarray] = {}
        self._oo_cols_len = 0
        self._rl_cols: Dict[str, np.ndarray] = {}
        self._rl_cols_len = 0
        self._sp_cols: Dict[str, np.ndarray] = {}
        self._sp_cols_len = 0
        self._lt_cols: Dict[str, np.ndarray] = {}
        self._lt_cols_len = 0

    # -- poses -------------------------------------------------------------
    def add_frame(self, frame_id: int, pose: np.ndarray):
        self.robot_poses[frame_id] = np.array(pose, dtype=np.float64)

    def get_robot_pose(self, frame_id: int) -> Optional[np.ndarray]:
        return self.robot_poses.get(frame_id)

    def set_robot_pose(self, frame_id: int, pose: np.ndarray):
        self.robot_poses[frame_id] = np.array(pose, dtype=np.float64)

    def max_frame_id(self) -> int:
        return max(self.robot_poses) if self.robot_poses else -1

    def frame_ids(self):
        return sorted(self.robot_poses)

    # -- features ----------------------------------------------------------
    def add_feature(self, feature_id: int, position: np.ndarray):
        self.features[feature_id] = np.array(position, dtype=np.float64)

    def has_feature(self, feature_id: int) -> bool:
        return feature_id in self.features

    def add_visual_factor(
        self, frame_id, camera_id, feature_id, pixel, std_dev
    ) -> int:
        fid = len(self.visual_factors)
        self.visual_factors.append(
            VisualFactor(frame_id, camera_id, feature_id, np.asarray(pixel, dtype=np.float64), std_dev)
        )
        self.visual_factors_by_frame[frame_id].append(fid)
        self.visual_factors_by_feature[feature_id].append(fid)
        if feature_id not in self.first_frame_for_feature:
            self.first_frame_for_feature[feature_id] = frame_id
        else:
            self.first_frame_for_feature[feature_id] = min(
                self.first_frame_for_feature[feature_id], frame_id
            )
        return fid

    # -- relative pose factors --------------------------------------------
    def add_pose_factor(self, before_frame, after_frame, rel_pose, covariance) -> int:
        fid = len(self.relpose_factors)
        self.relpose_factors.append(
            RelPoseFactor(
                before_frame,
                after_frame,
                np.asarray(rel_pose, dtype=np.float64),
                np.asarray(covariance, dtype=np.float64),
            )
        )
        self.relpose_factors_by_frame[before_frame].append(fid)
        self.relpose_factors_by_frame[after_frame].append(fid)
        return fid

    # -- objects -----------------------------------------------------------
    def add_new_ellipsoid(self, estimate, semantic_class: str) -> int:
        """addNewEllipsoid: allocates id and auto-adds the shape prior."""
        obj_id = self._next_object_id
        self._next_object_id += 1
        self.initialize_ellipsoid_with_id(obj_id, estimate, semantic_class)
        return obj_id

    def initialize_ellipsoid_with_id(self, obj_id, estimate, semantic_class):
        self.objects[obj_id] = EllipsoidNode(
            np.array(estimate, dtype=np.float64), semantic_class
        )
        self._next_object_id = max(self._next_object_id, obj_id + 1)
        if semantic_class in self.shape_mean_and_cov_by_class:
            mean, cov = self.shape_mean_and_cov_by_class[semantic_class]
            sid = len(self.shape_priors)
            self.shape_priors.append(
                ShapePriorFactorEntry(obj_id, np.asarray(mean, dtype=np.float64), np.asarray(cov, dtype=np.float64))
            )
            self.shape_priors_by_object[obj_id].append(sid)

    def add_ltm_object(self, obj_id, estimate, semantic_class):
        """Pre-insert a previous-session (LTM) ellipsoid with a known id
        (offline_object_visual_slam_main.cpp:200-229)."""
        self.initialize_ellipsoid_with_id(obj_id, estimate, semantic_class)
        self.ltm_object_ids.add(obj_id)

    def add_ltm_factor(self, obj_id, mean, covariance) -> int:
        fid = len(self.ltm_factors)
        self.ltm_factors.append(
            LtmFactorEntry(obj_id, np.asarray(mean, dtype=np.float64), np.asarray(covariance, dtype=np.float64))
        )
        self.ltm_factors_by_object[obj_id].append(fid)
        return fid

    def add_object_observation(self, obj_id, frame_id, camera_id, corners, covariance) -> int:
        fid = len(self.object_observations)
        self.object_observations.append(
            ObjectObservationFactor(
                frame_id,
                camera_id,
                obj_id,
                np.asarray(corners, dtype=np.float64),
                np.asarray(covariance, dtype=np.float64),
            )
        )
        self.obj_obs_by_frame[frame_id].append(fid)
        self.obj_obs_by_object[obj_id].append(fid)
        return fid

    def merge_objects(self, obj_to_remove: int, obj_to_keep: int):
        """Re-point all observation factors of obj_to_remove to obj_to_keep and
        delete obj_to_remove (+ its shape priors). LTM factors are never moved
        (two LTM objects are never merged; reference merge semantics)."""
        assert obj_to_remove in self.objects and obj_to_keep in self.objects
        for fid in self.obj_obs_by_object.pop(obj_to_remove, []):
            self.object_observations[fid].object_id = obj_to_keep
            if fid < self._oo_cols_len:  # keep the columnar mirror in sync
                self._oo_cols["object_id"][fid] = obj_to_keep
            self.obj_obs_by_object[obj_to_keep].append(fid)
        for sid in self.shape_priors_by_object.pop(obj_to_remove, []):
            # Drop duplicate shape priors on merge (keep target's own prior).
            self.shape_priors[sid] = None
            if sid < self._sp_cols_len:  # keep the columnar mirror in sync
                self._sp_cols["object_id"][sid] = -1
        self.shape_priors_by_object.pop(obj_to_remove, None)
        del self.objects[obj_to_remove]
        self.merged_objects[obj_to_remove] = obj_to_keep
        # Re-point stale tombstones.
        for old, tgt in list(self.merged_objects.items()):
            if tgt == obj_to_remove:
                self.merged_objects[old] = obj_to_keep

    # -- columnar factor views (struct-of-arrays) ---------------------------
    _COLUMN_SCHEMAS = {
        "vf": {
            "frame_id": (np.int64, ()), "camera_id": (np.int64, ()),
            "feature_id": (np.int64, ()), "pixel": (np.float64, (2,)),
            "std": (np.float64, ()),
        },
        "oo": {
            "frame_id": (np.int64, ()), "camera_id": (np.int64, ()),
            "object_id": (np.int64, ()), "corners": (np.float64, (4,)),
            "sqrt_inf": (np.float64, (4, 4)),
        },
        "rl": {
            "before": (np.int64, ()), "after": (np.int64, ()),
            "rel_t": (np.float64, (3,)), "rel_r": (np.float64, (3, 3)),
            "sqrt_inf": (np.float64, (6, 6)),
        },
        "sp": {
            "object_id": (np.int64, ()), "mean": (np.float64, (3,)),
            "sqrt_inf": (np.float64, (3, 3)),
        },
        "lt": {
            "object_id": (np.int64, ()), "mean": (np.float64, (7,)),
            "sqrt_inf": (np.float64, (7, 7)),
        },
    }

    @staticmethod
    def _readonly_views(cols, n):
        """Length-exact, non-writable views: the mirrors are shared caches —
        a caller mutating a returned column would corrupt every later
        build_problem in the session."""
        out = {}
        for k, v in cols.items():
            view = v[:n]
            view.flags.writeable = False
            out[k] = view
        return out

    @staticmethod
    def _seed_cols(cols, schema_key):
        if not cols:
            for name, (dt, shape) in PoseGraph._COLUMN_SCHEMAS[schema_key].items():
                cols[name] = np.empty((0,) + shape, dtype=dt)

    @staticmethod
    def _extend_cols(cols, n_old, n_new, make_row_arrays):
        """Grow each column geometrically and fill rows [n_old, n_new)."""
        if n_new == n_old:
            return
        new_rows = make_row_arrays()
        for name, rows in new_rows.items():
            rows = np.asarray(rows)
            if name not in cols:
                cols[name] = np.empty((0,) + rows.shape[1:], dtype=rows.dtype)
            buf = cols[name]
            if len(buf) < n_new:
                grown = np.empty(
                    (max(n_new, 2 * len(buf), 64),) + buf.shape[1:], dtype=buf.dtype
                )
                grown[:n_old] = buf[:n_old]
                cols[name] = grown
            cols[name][n_old:n_new] = rows

    def visual_factor_columns(self) -> Dict[str, np.ndarray]:
        """Columns over ALL visual factors: frame_id, camera_id, feature_id
        (int64), pixel (N,2), std (N,). Views are length-exact."""
        n_new = len(self.visual_factors)
        n_old = self._vf_cols_len

        def make_rows():
            fresh = self.visual_factors[n_old:n_new]
            return {
                "frame_id": np.array([f.frame_id for f in fresh], dtype=np.int64),
                "camera_id": np.array([f.camera_id for f in fresh], dtype=np.int64),
                "feature_id": np.array([f.feature_id for f in fresh], dtype=np.int64),
                "pixel": np.array([f.pixel for f in fresh], dtype=np.float64).reshape(
                    -1, 2
                ),
                "std": np.array(
                    [f.reprojection_error_std_dev for f in fresh], dtype=np.float64
                ),
            }

        self._seed_cols(self._vf_cols, "vf")
        self._extend_cols(self._vf_cols, n_old, n_new, make_rows)
        self._vf_cols_len = n_new
        return self._readonly_views(self._vf_cols, n_new)

    def object_observation_columns(self) -> Dict[str, np.ndarray]:
        """Columns over ALL object-observation factors: frame_id, camera_id,
        object_id (int64), corners (N,4), sqrt_inf (N,4,4) — the cached
        cov^-1 principal square root (covariances are immutable per factor;
        merges only re-point object_id, updated in merge_objects)."""
        n_new = len(self.object_observations)
        n_old = self._oo_cols_len

        def make_rows():
            fresh = self.object_observations[n_old:n_new]
            covs = np.array([f.covariance for f in fresh], dtype=np.float64).reshape(
                -1, 4, 4
            )
            return {
                "frame_id": np.array([f.frame_id for f in fresh], dtype=np.int64),
                "camera_id": np.array([f.camera_id for f in fresh], dtype=np.int64),
                "object_id": np.array([f.object_id for f in fresh], dtype=np.int64),
                "corners": np.array(
                    [f.corners for f in fresh], dtype=np.float64
                ).reshape(-1, 4),
                "sqrt_inf": batched_sqrt_inf(covs),
            }

        self._seed_cols(self._oo_cols, "oo")
        self._extend_cols(self._oo_cols, n_old, n_new, make_rows)
        self._oo_cols_len = n_new
        return self._readonly_views(self._oo_cols, n_new)

    def relpose_factor_columns(self) -> Dict[str, np.ndarray]:
        """before/after (int64), rel_t (N,3), rel_r (N,3,3) rotation matrices,
        sqrt_inf (N,6,6) — conversions cached once per factor."""
        n_new = len(self.relpose_factors)
        n_old = self._rl_cols_len

        def make_rows():
            from scipy.spatial.transform import Rotation

            fresh = self.relpose_factors[n_old:n_new]
            rel = np.array([f.rel_pose for f in fresh], dtype=np.float64).reshape(-1, 6)
            covs = np.array([f.covariance for f in fresh], dtype=np.float64).reshape(
                -1, 6, 6
            )
            return {
                "before": np.array([f.before_frame for f in fresh], dtype=np.int64),
                "after": np.array([f.after_frame for f in fresh], dtype=np.int64),
                "rel_t": rel[:, :3],
                "rel_r": Rotation.from_rotvec(rel[:, 3:6]).as_matrix().reshape(-1, 3, 3),
                "sqrt_inf": batched_sqrt_inf(covs),
            }

        self._seed_cols(self._rl_cols, "rl")
        self._extend_cols(self._rl_cols, n_old, n_new, make_rows)
        self._rl_cols_len = n_new
        return self._readonly_views(self._rl_cols, n_new)

    def shape_prior_columns(self) -> Dict[str, np.ndarray]:
        """object_id (int64, -1 for merge-tombstoned entries), mean (N,3),
        sqrt_inf (N,3,3)."""
        n_new = len(self.shape_priors)
        n_old = self._sp_cols_len

        def make_rows():
            fresh = self.shape_priors[n_old:n_new]
            obj = np.array(
                [-1 if f is None else f.object_id for f in fresh], dtype=np.int64
            )
            mean = np.array(
                [np.zeros(3) if f is None else f.mean for f in fresh],
                dtype=np.float64,
            ).reshape(-1, 3)
            covs = np.array(
                [np.eye(3) if f is None else f.covariance for f in fresh],
                dtype=np.float64,
            ).reshape(-1, 3, 3)
            return {"object_id": obj, "mean": mean, "sqrt_inf": batched_sqrt_inf(covs)}

        self._seed_cols(self._sp_cols, "sp")
        self._extend_cols(self._sp_cols, n_old, n_new, make_rows)
        self._sp_cols_len = n_new
        return self._readonly_views(self._sp_cols, n_new)

    def ltm_factor_columns(self) -> Dict[str, np.ndarray]:
        """object_id (int64), mean (N,7), sqrt_inf (N,7,7)."""
        n_new = len(self.ltm_factors)
        n_old = self._lt_cols_len

        def make_rows():
            fresh = self.ltm_factors[n_old:n_new]
            covs = np.array([f.covariance for f in fresh], dtype=np.float64).reshape(
                -1, 7, 7
            )
            return {
                "object_id": np.array([f.object_id for f in fresh], dtype=np.int64),
                "mean": np.array([f.mean for f in fresh], dtype=np.float64).reshape(
                    -1, 7
                ),
                "sqrt_inf": batched_sqrt_inf(covs),
            }

        self._seed_cols(self._lt_cols, "lt")
        self._extend_cols(self._lt_cols, n_old, n_new, make_rows)
        self._lt_cols_len = n_new
        return self._readonly_views(self._lt_cols, n_new)

    # -- queries used by the problem builder -------------------------------
    def visual_factor_ids_in_window(self, min_frame, max_frame) -> List[int]:
        out = []
        for f in range(min_frame, max_frame + 1):
            out.extend(self.visual_factors_by_frame.get(f, []))
        return out

    def obj_obs_ids_in_window(self, min_frame, max_frame) -> List[int]:
        out = []
        for f in range(min_frame, max_frame + 1):
            out.extend(self.obj_obs_by_frame.get(f, []))
        return out

    def relpose_ids_in_window(self, min_frame, max_frame) -> List[int]:
        seen = set()
        out = []
        for f in range(min_frame, max_frame + 1):
            for fid in self.relpose_factors_by_frame.get(f, []):
                if fid in seen:
                    continue
                fac = self.relpose_factors[fid]
                if (
                    fac.before_frame >= min_frame
                    and fac.after_frame <= max_frame
                ):
                    seen.add(fid)
                    out.append(fid)
        return out

    # -- value snapshots (two-phase revert / jump reversion) ---------------
    def snapshot_values(self) -> dict:
        return {
            "poses": {k: v.copy() for k, v in self.robot_poses.items()},
            "features": {k: v.copy() for k, v in self.features.items()},
            "objects": {k: v.ellipsoid.copy() for k, v in self.objects.items()},
        }

    def restore_values(self, snap: dict):
        for k, v in snap["poses"].items():
            self.robot_poses[k] = v.copy()
        for k, v in snap["features"].items():
            self.features[k] = v.copy()
        for k, v in snap["objects"].items():
            if k in self.objects:
                self.objects[k].ellipsoid = v.copy()

    # -- checkpoint serialization ------------------------------------------
    def get_state(self) -> dict:
        """JSON-serializable full state (ObjectAndReprojectionFeaturePoseGraphState
        analog, object_pose_graph.h:263-273)."""
        return {
            "robot_poses": {str(k): v.tolist() for k, v in self.robot_poses.items()},
            "features": {str(k): v.tolist() for k, v in self.features.items()},
            "first_frame_for_feature": {
                str(k): v for k, v in self.first_frame_for_feature.items()
            },
            "visual_factors": [
                [f.frame_id, f.camera_id, f.feature_id, f.pixel.tolist(), f.reprojection_error_std_dev]
                for f in self.visual_factors
            ],
            "relpose_factors": [
                [f.before_frame, f.after_frame, f.rel_pose.tolist(), f.covariance.tolist()]
                for f in self.relpose_factors
            ],
            "objects": {
                str(k): [v.ellipsoid.tolist(), v.semantic_class]
                for k, v in self.objects.items()
            },
            "object_observations": [
                [f.frame_id, f.camera_id, f.object_id, f.corners.tolist(), f.covariance.tolist()]
                for f in self.object_observations
            ],
            "shape_priors": [
                None if f is None else [f.object_id, f.mean.tolist(), f.covariance.tolist()]
                for f in self.shape_priors
            ],
            "ltm_factors": [
                [f.object_id, f.mean.tolist(), f.covariance.tolist()]
                for f in self.ltm_factors
            ],
            "ltm_object_ids": sorted(self.ltm_object_ids),
            "next_object_id": self._next_object_id,
            "merged_objects": {str(k): v for k, v in self.merged_objects.items()},
        }

    @classmethod
    def from_state(
        cls, state: dict, cameras: Dict[int, CameraInfo], shape_priors_by_class=None
    ) -> "PoseGraph":
        pg = cls(cameras, shape_priors_by_class)
        for k, v in state["robot_poses"].items():
            pg.add_frame(int(k), np.array(v))
        for k, v in state["features"].items():
            pg.features[int(k)] = np.array(v)
        pg.first_frame_for_feature = {
            int(k): int(v) for k, v in state["first_frame_for_feature"].items()
        }
        for f in state["visual_factors"]:
            fid = len(pg.visual_factors)
            pg.visual_factors.append(
                VisualFactor(f[0], f[1], f[2], np.array(f[3]), f[4])
            )
            pg.visual_factors_by_frame[f[0]].append(fid)
            pg.visual_factors_by_feature[f[2]].append(fid)
        for f in state["relpose_factors"]:
            pg.add_pose_factor(f[0], f[1], np.array(f[2]), np.array(f[3]))
        for k, v in state["objects"].items():
            pg.objects[int(k)] = EllipsoidNode(np.array(v[0]), v[1])
        for f in state["object_observations"]:
            fid = len(pg.object_observations)
            pg.object_observations.append(
                ObjectObservationFactor(f[0], f[1], f[2], np.array(f[3]), np.array(f[4]))
            )
            pg.obj_obs_by_frame[f[0]].append(fid)
            pg.obj_obs_by_object[f[2]].append(fid)
        for f in state["shape_priors"]:
            if f is None:
                pg.shape_priors.append(None)
            else:
                sid = len(pg.shape_priors)
                pg.shape_priors.append(
                    ShapePriorFactorEntry(f[0], np.array(f[1]), np.array(f[2]))
                )
                pg.shape_priors_by_object[f[0]].append(sid)
        for f in state["ltm_factors"]:
            pg.add_ltm_factor(f[0], np.array(f[1]), np.array(f[2]))
        pg.ltm_object_ids = set(state["ltm_object_ids"])
        pg._next_object_id = state["next_object_id"]
        pg.merged_objects = {int(k): v for k, v in state.get("merged_objects", {}).items()}
        return pg
