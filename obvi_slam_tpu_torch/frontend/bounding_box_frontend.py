"""Feature-based bounding-box frontend: data association for object detections.

Counterpart of ``obvi_slam_tpu/frontend/bounding_box_frontend.py`` (the
reference's default object data association):

  per (frame, camera):
    filter (confidence > min)  ->  features-in-inflated-bbox context
    -> candidates (same semantic class: pending + pose-graph objects)
    -> prune (max per-observation feature intersection >= threshold)
    -> score (average feature-IoU over the candidate's observations)
    -> greedy assignment
    -> existing object: add observation; else append/create pending object
    -> refine pending estimates (mini-BA: bbox + shape prior, poses fixed,
       one LM solve of the port's solver on ``device``, its iterations
       to the optimization logger as pending_obj_est)
    -> tryInitializeEllipsoid -> merge-or-create (geometric similarity =
       negative center distance within max_merge_distance)
    -> cleanup: stale pending discard + feature-validity-window expiry

The association is host-side set logic; only the mini-BA runs on the
device. Its problem has bounding-box and shape-prior factors only, a (1, 3)
dummy point state and no reprojection rows. Its sizes are the reference's
capacity buckets, grown monotonically over the session in
``_mini_ba_caps``: poses from 8, objects and shape priors from 4 and boxes
from 16 up by powers of two, and the plan's object pair caps. Padding rows
are zero, not free and unreferenced, so the result equals an unpadded
solve's up to roundoff, and the card's CUDA graphs (cached by shape) see a
few shapes per session instead of one per pending set.

With a ``mesh`` (the runner's, ``parallel.make_mesh``) every rank runs the
frontend, and rank 0's mini-BA estimates, with the flags derived from them,
replace every rank's before any decision reads them: one broadcast after
the refinement and one after the initialization checks, per call. Without
it the ranks' mini-BAs could end apart in their last bits on the card
(``index_add_`` sums in a varying order), decide merges or initialisations
differently and then build different problems.

Cross-session note: for the feature-based frontend the LTM appearance payload
is empty, so LTM objects re-associate geometrically via the merge path.
``ltm_merges`` counts the objects merged into an LTM object: pending objects
(``_merge_pending``) and, through ``apply_merges`` with this frontend, the
post-session merge's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

import scipy.linalg
import torch

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch import geometry as geo
from obvi_slam_tpu_torch import optlog
from obvi_slam_tpu_torch import types as T
from obvi_slam_tpu_torch.frontend.visual_features import _pose_to_rt
from obvi_slam_tpu_torch.offline_data import RawBoundingBox
from obvi_slam_tpu_torch.parallel import comm
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.solver import HuberParams, build_schur_plan_host, solve, solve_fused
from obvi_slam_tpu_torch.solver.lm_fused import _map
from obvi_slam_tpu_torch.solver.problem import _bucket, camera_bundle_from_pose_graph
from obvi_slam_tpu_torch.timing import HOST_WAIT, timer

# The plan's object caps that the mini-BA pins (solver.plan.build_schur_plan).
OB_PLAN_CAP_KEYS = ("ob_pair", "ob_cross", "ob_dest", "ob_slot_land", "ob_slot_c")

NOT_INITIALIZED = 0
ENOUGH_VIEWS_FOR_MERGE = 1
SUFFICIENT_VIEWS_FOR_NEW = 2


@dataclass
class PendingObservation:
    """UninitializedObjectFactor."""

    frame_id: int
    camera_id: int
    corners: np.ndarray  # (4,) [x_min, x_max, y_min, y_max]
    covariance: np.ndarray  # (4, 4)
    confidence: float


@dataclass
class PendingObject:
    """UninitializedEllispoidInfo (bounding_box_front_end.h:27-35)."""

    semantic_class: str
    min_frame_id: int
    max_frame_id: int
    observations: List[PendingObservation] = field(default_factory=list)
    # frame_id -> cam_id -> set of feature ids (appearance info)
    observed_feats: Dict[int, Dict[int, Set[int]]] = field(default_factory=dict)
    object_estimate: Optional[np.ndarray] = None  # (7,)
    max_confidence: float = 0.0
    ready_for_merge: bool = False


def corners_from_pair(bb: RawBoundingBox) -> np.ndarray:
    return np.asarray(bb.corners, dtype=np.float64)


def bb_covariance(
    bb: RawBoundingBox,
    camera_id: int,
    cov_params: cfg.BoundingBoxCovGenParams,
    img_heights_and_widths: Dict[int, Tuple[float, float]],
) -> np.ndarray:
    """getBoundingBoxCovarianceGenerator (bounding_box_front_end_creation_utils.h:55-103):
    corners near the image edge get the (large) boundary variance."""
    cov = np.array(cov_params.bounding_box_cov, dtype=np.float64)
    x_min, x_max, y_min, y_max = bb.corners
    if x_min < cov_params.near_edge_threshold:
        cov[0, 0] = cov_params.image_boundary_variance
    if y_min < cov_params.near_edge_threshold:
        cov[2, 2] = cov_params.image_boundary_variance
    if camera_id in img_heights_and_widths:
        height, width = img_heights_and_widths[camera_id]
        if x_max > (width - cov_params.near_edge_threshold):
            cov[1, 1] = cov_params.image_boundary_variance
        if y_max > (height - cov_params.near_edge_threshold):
            cov[3, 3] = cov_params.image_boundary_variance
    return cov


def object_depth_given_height(corners, height, fy):
    """getObjectDepthGivenHeight (bounding_box_front_end_helpers.h:204-214)."""
    y_diff = corners[3] - corners[2]
    return height * fy / y_diff


def single_view_ellipsoid_estimate(
    pg: PoseGraph, frame_id, camera_id, semantic_class, corners
) -> Optional[np.ndarray]:
    """generateSingleViewEllipsoidEstimate (bounding_box_front_end_helpers.h:217-264):
    depth from class-mean height, back-project bbox center, zero yaw."""
    if semantic_class not in pg.shape_mean_and_cov_by_class:
        return None
    mean_dim, _ = pg.shape_mean_and_cov_by_class[semantic_class]
    cam = pg.cameras[camera_id]
    fy = cam.intrinsics[1, 1]
    depth = object_depth_given_height(corners, mean_dim[2], fy)
    center = np.array(
        [(corners[0] + corners[1]) / 2.0, (corners[2] + corners[3]) / 2.0, 1.0]
    )
    pos_rel_cam = depth * (np.linalg.inv(cam.intrinsics) @ center)
    pose = pg.get_robot_pose(frame_id)
    if pose is None:
        return None
    r, t = _pose_to_rt(pose)
    cam_r = cam.extrinsics_r
    cam_t = cam.extrinsics_t
    # camera pose in world = robot_pose ∘ extrinsics
    rw = r @ cam_r
    tw = r @ cam_t + t
    global_pos = rw @ pos_rel_cam + tw
    return np.concatenate([global_pos, [0.0], np.asarray(mean_dim, dtype=np.float64)])


class FeatureBasedBoundingBoxFrontEnd:
    def __init__(
        self,
        pg: PoseGraph,
        association_params: cfg.FeatureBasedBbAssociationParams,
        cov_gen_params: cfg.BoundingBoxCovGenParams,
        similarity_params: cfg.GeometricSimilarityScorerParams,
        img_heights_and_widths: Optional[Dict[int, Tuple[float, float]]] = None,
        ltm_front_end_data: Optional[Dict[int, dict]] = None,
        dtype=np.float64,
        device="cuda",
        plain: bool = False,
        mesh=None,
    ):
        """``dtype``, ``device`` and ``plain`` are those of the pending
        mini-BA (``plain``: the kernels' plain versions, reference runs);
        ``mesh``: the runner's, whose rank 0 decides the estimates."""
        self.pg = pg
        self.params = association_params
        self.cov_params = cov_gen_params
        self.similarity_params = similarity_params
        self.img_hw = img_heights_and_widths or {}
        self.dtype = dtype
        self.device = device
        self.plain = plain
        self.mesh = mesh
        # Per broadcast from rank 0: the largest difference this rank's
        # values had from rank 0's before it.
        self.rank_differences: List[float] = []

        self.pending: List[PendingObject] = []
        self.ltm_merges = 0
        # The mini-BA's session capacities (the runner's caps pools' role):
        # bucketed and max-accumulated over the session's mini-BAs.
        self._mini_ba_caps: Dict[str, int] = {}
        # obj_id -> frame -> cam -> set(feature_ids)
        self.object_appearance: Dict[int, Dict[int, Dict[int, Set[int]]]] = {}
        # Restore LTM appearance payload (empty for the feature-based frontend,
        # bounding_box_front_end.h:348-365).
        for obj_id in (ltm_front_end_data or {}):
            self.object_appearance[int(obj_id)] = {}
        for obj_id in pg.ltm_object_ids:
            self.object_appearance.setdefault(obj_id, {})

    # ------------------------------------------------------------------
    def objects_with_class(self, semantic_class) -> List[int]:
        return [
            o for o, node in self.pg.objects.items() if node.semantic_class == semantic_class
        ]

    def add_bounding_box_observations(
        self,
        frame_id: int,
        camera_id: int,
        bounding_boxes: List[RawBoundingBox],
        observed_features: Dict[int, np.ndarray],
    ):
        """observed_features: feat_id -> pixel (2,) for this (frame, cam)."""
        with timer("bb_front_end_add_bb_obs"):
            self._add_bounding_box_observations(
                frame_id, camera_id, bounding_boxes, observed_features
            )

    def _add_bounding_box_observations(
        self, frame_id, camera_id, bounding_boxes, observed_features
    ):
        filtered = [
            bb
            for bb in bounding_boxes
            if bb.detection_confidence > self.params.min_bb_confidence
        ]
        # Per-bb association context (template hook:
        # generateSingleBoundingBoxContextInfo). Feature-based: the set of
        # features inside the inflated box; Roshan: histogram + 1-view est.
        contexts = [
            self._make_bb_context(frame_id, camera_id, bb, observed_features)
            for bb in filtered
        ]

        # --- association --------------------------------------------------
        assignments = self._assign(frame_id, camera_id, filtered, contexts)

        # --- record observations ------------------------------------------
        for idx, (bb, assoc) in enumerate(zip(filtered, assignments)):
            cov = bb_covariance(bb, camera_id, self.cov_params, self.img_hw)
            corners = corners_from_pair(bb)
            if assoc[0] == "object":
                obj_id = assoc[1]
                self.pg.add_object_observation(obj_id, frame_id, camera_id, corners, cov)
                self.object_appearance.setdefault(obj_id, {}).setdefault(frame_id, {})[
                    camera_id
                ] = contexts[idx]
            else:
                pend_idx = assoc[1]
                obs = PendingObservation(frame_id, camera_id, corners, cov, bb.detection_confidence)
                if pend_idx >= len(self.pending):
                    pend = PendingObject(
                        semantic_class=bb.semantic_class,
                        min_frame_id=frame_id,
                        max_frame_id=frame_id,
                    )
                    pend.observations.append(obs)
                    pend.observed_feats.setdefault(frame_id, {})[camera_id] = contexts[idx]
                    pend.max_confidence = bb.detection_confidence
                    pend.object_estimate = single_view_ellipsoid_estimate(
                        self.pg, frame_id, camera_id, bb.semantic_class, corners
                    )
                    self.pending.append(pend)
                else:
                    pend = self.pending[pend_idx]
                    pend.observations.append(obs)
                    pend.min_frame_id = min(pend.min_frame_id, frame_id)
                    pend.max_frame_id = max(pend.max_frame_id, frame_id)
                    pend.observed_feats.setdefault(frame_id, {})[camera_id] = contexts[idx]
                    pend.max_confidence = max(pend.max_confidence, bb.detection_confidence)
                    if pend.object_estimate is None:
                        pend.object_estimate = single_view_ellipsoid_estimate(
                            self.pg, frame_id, camera_id, bb.semantic_class, corners
                        )

        # --- refine pending estimates (mini-BA) ---------------------------
        assigned_pending = {
            assoc[1] for assoc in assignments if assoc[0] == "pending"
        }
        existing_associated = {
            assoc[1] for assoc in assignments if assoc[0] == "object"
        }
        targets = self._refine_pending_estimates(assigned_pending)
        if self.mesh is not None and targets:
            rows = self._from_rank0(np.array([
                np.append(self.pending[i].object_estimate, self.pending[i].ready_for_merge)
                for i in targets]))
            for i, row in zip(targets, rows):
                self.pending[i].object_estimate = row[:7].copy()
                self.pending[i].ready_for_merge = bool(row[7])

        # --- initialize / merge / create ----------------------------------
        mergable: Dict[int, Tuple[int, np.ndarray]] = {}
        statuses = []
        for pend_idx in assigned_pending:
            if pend_idx >= len(self.pending):
                continue
            status, est = self._try_initialize(self.pending[pend_idx])
            statuses.append((pend_idx, status, est))
        if self.mesh is not None and statuses:
            rows = self._from_rank0(np.array([
                np.concatenate([[i, status], np.full(7, np.nan) if est is None else est])
                for i, status, est in statuses]))
            statuses = [(int(r[0]), int(r[1]), r[2:].copy()) for r in rows]
        for pend_idx, status, est in statuses:
            if status in (ENOUGH_VIEWS_FOR_MERGE, SUFFICIENT_VIEWS_FOR_NEW):
                mergable[pend_idx] = (status, est)

        to_merge, to_add = self._search_for_merges(mergable, existing_associated)
        removed = self._merge_pending(to_merge)
        for pend_idx, est in to_add:
            pend = self.pending[pend_idx]
            obj_id = self.pg.add_new_ellipsoid(est, pend.semantic_class)
            self.object_appearance[obj_id] = dict(pend.observed_feats)
            for obs in pend.observations:
                self.pg.add_object_observation(
                    obj_id, obs.frame_id, obs.camera_id, obs.corners, obs.covariance
                )
            removed.append(pend_idx)

        for idx in sorted(set(removed), reverse=True):
            del self.pending[idx]

        # Merge remaining ready pending into existing objects.
        mergable2 = {
            i: (ENOUGH_VIEWS_FOR_MERGE, p.object_estimate)
            for i, p in enumerate(self.pending)
            if p.ready_for_merge and p.object_estimate is not None
        }
        to_merge2, _ = self._search_for_merges(mergable2, set())
        removed2 = self._merge_pending(to_merge2)
        for idx in sorted(set(removed2), reverse=True):
            del self.pending[idx]

        self._cleanup(frame_id)

    def _from_rank0(self, rows: np.ndarray) -> np.ndarray:
        """Rank 0's ``rows`` (f64) on every rank, in one broadcast; notes
        how far this rank's own were from them (NaN equal to NaN)."""
        local = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float64))
        agreed = comm.broadcast(local.to(self.mesh.device), self.mesh).cpu().numpy()
        diff = np.abs(agreed - rows)
        diff[np.isnan(agreed) & np.isnan(rows)] = 0.0
        self.rank_differences.append(float(np.max(np.nan_to_num(diff, nan=np.inf))))
        return agreed

    # ------------------------------------------------------------------
    def _make_bb_context(self, frame_id, camera_id, bb, observed_features):
        """Feature-based context: ids of features inside the inflated bbox."""
        infl = self.params.bounding_box_inflation_size
        x_min, x_max, y_min, y_max = bb.corners
        return {
            fid
            for fid, px in observed_features.items()
            if (x_min - infl) <= px[0] <= (x_max + infl)
            and (y_min - infl) <= px[1] <= (y_max + infl)
        }

    def _score_candidate_entries(self, frame_id, camera_id, bb, feats):
        """identify -> prune -> score for one bb. Feature-based: feature
        overlap pruning + average-IoU scoring."""
        candidates = []
        for pend_idx, pend in enumerate(self.pending):
            if pend.semantic_class == bb.semantic_class:
                candidates.append(("pending", pend_idx, pend.observed_feats))
        for obj_id in self.objects_with_class(bb.semantic_class):
            candidates.append(
                ("object", obj_id, self.object_appearance.get(obj_id, {}))
            )
        entries = []
        for kind, ident, observed in candidates:
            # prune: max per-observation intersection count
            overlap_by_obs = {}
            max_overlap = 0
            for fr, cams in observed.items():
                for cam, featset in cams.items():
                    n = len(feats & featset)
                    overlap_by_obs[(fr, cam)] = n
                    max_overlap = max(max_overlap, n)
            if max_overlap < self.params.min_overlapping_features_for_match:
                continue
            # score: average IoU over ALL candidate observations
            total_obs = 0
            iou_sum = 0.0
            for fr, cams in observed.items():
                for cam, featset in cams.items():
                    total_obs += 1
                    inter = overlap_by_obs[(fr, cam)]
                    if inter != 0:
                        iou_sum += inter / (len(feats) + len(featset) - inter)
            score = iou_sum / total_obs if total_obs else -np.inf
            entries.append(((kind, ident), score))
        return entries

    def _assign(self, frame_id, camera_id, filtered, contexts):
        """identify -> prune -> score -> greedy assign. Returns per-bb
        ("object", obj_id) or ("pending", pending_idx)."""
        scored_candidates = [
            self._score_candidate_entries(frame_id, camera_id, bb, ctx)
            for bb, ctx in zip(filtered, contexts)
        ]

        # greedilyAssignBoundingBoxes (bounding_box_front_end_helpers.h:125-184)
        flattened = []
        for bb_idx, entries in enumerate(scored_candidates):
            for cand, score in entries:
                flattened.append((bb_idx, cand, score))
        flattened.sort(key=lambda x: -x[2])
        claimed = set()
        assignment_map = {}
        for bb_idx, cand, score in flattened:
            if bb_idx in assignment_map or cand in claimed:
                continue
            claimed.add(cand)
            assignment_map[bb_idx] = cand
        next_free = len(self.pending)
        assignments = []
        for bb_idx in range(len(filtered)):
            if bb_idx in assignment_map:
                assignments.append(assignment_map[bb_idx])
            else:
                assignments.append(("pending", next_free))
                next_free += 1
        return assignments

    # ------------------------------------------------------------------
    def _refine_pending_estimates(self, assigned_pending: Set[int]):
        """refineInitialEstimateForPendingObjects (pending_object_estimator.cpp:19-151):
        mini-BA over pending ellipsoids (bbox + shape prior, poses constant)
        on the shared LM solver; then update ready_for_merge. Returns the
        pending indices it refined."""
        # Estimate set: assigned-this-round with an estimate + others ready.
        targets = []
        for idx in sorted(assigned_pending):
            if idx < len(self.pending) and self.pending[idx].object_estimate is not None:
                targets.append(idx)
        for idx, pend in enumerate(self.pending):
            if idx in assigned_pending:
                continue
            if pend.ready_for_merge and pend.object_estimate is not None:
                targets.append(idx)
        if targets:
            with timer("refine_initial_estimate_for_pending_objects"):
                self._run_pending_mini_ba(targets)
        # Update ready_for_merge flags.
        for idx in targets:
            pend = self.pending[idx]
            pend.ready_for_merge = (
                len(pend.observations) >= self.params.min_observations_for_local_est
                and pend.max_confidence
                >= self.params.required_min_conf_for_initialization
                and pend.object_estimate is not None
            )
        return targets

    def _run_pending_mini_ba(self, targets: List[int]):
        """One LM solve over the target pending ellipsoids: bounding-box
        factors of their observations and their class shape priors, the
        observing poses fixed, no visual factors; at the session's
        ``_mini_ba_caps``, which it grows."""
        with timer("mini_ba_build"):
            args = self._build_mini_ba(targets)
        with timer("mini_ba_solve"):
            self._solve_mini_ba(targets, *args)

    def _build_mini_ba(self, targets: List[int]):
        """The mini-BA's problem, assembled on the host and then copied to the
        device: (state, cams, tables, plan, free, huber, LM parameters,
        object row of each target)."""
        est_params = self.params.pending_obj_estimator_params
        dtype, device = self.dtype, "cpu"

        cams, cam_idx_map = camera_bundle_from_pose_graph(self.pg, dtype, device=device)
        fx, fy, cx, cy = (x.numpy() for x in (cams.fx, cams.fy, cams.cx, cams.cy))

        frames = sorted(
            {obs.frame_id for idx in targets for obs in self.pending[idx].observations}
        )
        pose_row_of = {f: i for i, f in enumerate(frames)}
        obj_row_of = {idx: i for i, idx in enumerate(targets)}
        caps = self._mini_ba_caps
        n_pose_cap = max(caps.get("n_pose", 0), _bucket(len(frames), minimum=8))
        n_obj_cap = max(caps.get("n_obj", 0), _bucket(len(targets), minimum=4))

        bb_obj, bb_pose, bb_cam, bb_corners, bb_si = [], [], [], [], []
        for idx in targets:
            for obs in self.pending[idx].observations:
                ci = cam_idx_map[obs.camera_id]
                bb_obj.append(obj_row_of[idx])
                bb_pose.append(pose_row_of[obs.frame_id])
                bb_cam.append(ci)
                bb_corners.append(obs.corners)
                # Host matrix square root (scipy), as in the reference.
                sqrt_inf = np.real(
                    scipy.linalg.sqrtm(np.linalg.inv(obs.covariance))
                ) @ np.diag([fx[ci], fx[ci], fy[ci], fy[ci]])
                bb_si.append(sqrt_inf)
        rect_corners = geo.rectify_bb_corners(
            torch.from_numpy(np.reshape(bb_corners, (-1, 4))),
            *(torch.from_numpy(v[bb_cam]) for v in (fx, fy, cx, cy)),
        ).numpy()
        sp_obj, sp_mean, sp_si = [], [], []
        for idx in targets:
            cls = self.pending[idx].semantic_class
            if cls not in self.pg.shape_mean_and_cov_by_class:
                continue
            mean, cov = self.pg.shape_mean_and_cov_by_class[cls]
            sp_obj.append(obj_row_of[idx])
            sp_mean.append(mean)
            sp_si.append(np.real(scipy.linalg.sqrtm(np.linalg.inv(cov))))

        bb_cap = max(caps.get("bbox", 0), _bucket(len(bb_obj)))
        sh_cap = max(caps.get("shape", 0), _bucket(len(sp_obj), minimum=4))
        tables = T.empty_factor_tables(dtype=dtype, device=device)._replace(
            bbox=T.make_bounding_box_factors(
                bb_obj, bb_pose, bb_cam, rect_corners, bb_si, capacity=bb_cap, dtype=dtype,
                device=device,
            ),
            shape=T.make_shape_prior_factors(
                sp_obj, sp_mean, sp_si, capacity=sh_cap, dtype=dtype, device=device
            ),
        )

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        # Padding rows: zero, not free, referenced by no factor.
        poses = np.zeros((n_pose_cap, T.POSE_DIM))
        poses[: len(frames)] = np.stack([self.pg.robot_poses[f] for f in frames])
        objects = np.zeros((n_obj_cap, T.ELLIPSOID_DIM))
        objects[: len(targets)] = np.stack([self.pending[idx].object_estimate for idx in targets])
        obj_free = np.zeros(n_obj_cap, dtype=bool)
        obj_free[: len(targets)] = True
        state = T.BAState(
            poses=dev(poses.astype(dtype)),
            points=dev(np.zeros((1, T.POINT_DIM), dtype=dtype)),
            objects=dev(objects.astype(dtype)),
        )
        free = T.FreeMasks(
            poses=dev(np.zeros(n_pose_cap, dtype=bool)),
            points=dev(np.zeros(1, dtype=bool)),
            objects=dev(obj_free),
        )
        plan_caps = {k: caps[k] for k in OB_PLAN_CAP_KEYS if k in caps}
        plan = build_schur_plan_host(
            [], [], tables.reproj.capacity, bb_pose, bb_obj, tables.bbox.capacity,
            plan_caps or None, n_pose=n_pose_cap, device=device,
        )
        caps.update(n_pose=n_pose_cap, n_obj=n_obj_cap, bbox=bb_cap, shape=sh_cap)
        for k, n in zip(OB_PLAN_CAP_KEYS, (
            plan.ob_pair_pose.shape[0], plan.ob_cross_a.shape[0], plan.ob_dest_a.shape[0],
            plan.ob_slot_gather.shape[0], plan.ob_slot_gather.shape[1],
        )):
            caps[k] = max(caps.get(k, 0), n)
        obj_params = est_params.object_residual_params
        huber = HuberParams(
            bbox=obj_params.object_observation_huber_loss_param,
            shape=obj_params.shape_dim_prior_factor_huber_loss_param,
            invalid_ellipse_error=obj_params.invalid_ellipsoid_error_val,
        )
        # The runner imports this package: import its helper at call time.
        from obvi_slam_tpu_torch.runner import lm_params_from_config

        lm_params = lm_params_from_config(est_params.solver_params)
        with timer("problem_build_upload"):
            state, cams, tables, plan, free = _map(lambda t: t.to(self.device),
                                                   (state, cams, tables, plan, free))
        return state, cams, tables, plan, free, huber, lm_params, obj_row_of

    def _solve_mini_ba(self, targets, state, cams, tables, plan, free, huber, lm_params,
                       obj_row_of):
        """The mini-BA's LM solve; the new estimates go to the pending objects."""
        if torch.device(self.device).type == "cuda":
            # The fused solve (CUDA graphs), with records when the logger
            # reads them, as the reference's on an accelerator.
            new_state, summary = solve_fused(
                state, cams, tables, plan, free, params=lm_params, huber=huber,
                with_records=optlog.IterationLoggerFactory.instance().enabled, plain=self.plain,
            )
        else:
            new_state, summary = solve(
                state, cams, tables, plan, free, params=lm_params, huber=huber, plain=self.plain
            )
        optlog.IterationLoggerFactory.instance().log_iterations(
            optlog.PENDING_ESTIMATOR_TYPE, "_".join(str(t) for t in targets), summary,
            7 * len(targets),
        )
        with timer(HOST_WAIT):
            new_objects = new_state.objects.cpu().numpy().astype(np.float64)
        for idx in targets:
            self.pending[idx].object_estimate = new_objects[obj_row_of[idx]].copy()

    # ------------------------------------------------------------------
    def _try_initialize(self, pend: PendingObject):
        """tryInitializeEllipsoid (feature_based...h:674-697)."""
        if not pend.ready_for_merge:
            return NOT_INITIALIZED, None
        est = pend.object_estimate
        if len(pend.observations) < self.params.min_observations:
            return ENOUGH_VIEWS_FOR_MERGE, est
        return SUFFICIENT_VIEWS_FOR_NEW, est

    def _search_for_merges(self, mergable: Dict[int, Tuple[int, np.ndarray]], existing_associated):
        """searchForObjectMerges (feature_based...h:742-843): candidates with
        no (frame, cam) observation overlap + center-distance scoring."""
        to_merge: List[Tuple[int, int]] = []  # (pending_idx, obj_id)
        to_add: List[Tuple[int, np.ndarray]] = []
        if not mergable:
            return to_merge, to_add

        flattened = []
        for pend_idx, (status, est) in mergable.items():
            pend = self.pending[pend_idx]
            pend_obs = {(o.frame_id, o.camera_id) for o in pend.observations}
            for obj_id in self.objects_with_class(pend.semantic_class):
                if obj_id in existing_associated:
                    continue
                obj_obs = {
                    (self.pg.object_observations[f].frame_id, self.pg.object_observations[f].camera_id)
                    for f in self.pg.obj_obs_by_object.get(obj_id, [])
                }
                if pend_obs & obj_obs:
                    continue  # overlapping observations -> distinct objects
                obj_est = self.pg.objects[obj_id].ellipsoid
                if self.similarity_params.x_y_only_merge:
                    dist = np.linalg.norm(est[:2] - obj_est[:2])
                else:
                    dist = np.linalg.norm(est[:3] - obj_est[:3])
                if dist > self.similarity_params.max_merge_distance:
                    continue
                flattened.append(((pend_idx, obj_id), -dist))
        flattened.sort(key=lambda x: -x[1])

        unmerged = set(mergable)
        matched_objects = set()
        for (pend_idx, obj_id), score in flattened:
            if pend_idx not in unmerged or obj_id in matched_objects:
                continue
            unmerged.discard(pend_idx)
            matched_objects.add(obj_id)
            to_merge.append((pend_idx, obj_id))
        for pend_idx in unmerged:
            status, est = mergable[pend_idx]
            if status == SUFFICIENT_VIEWS_FOR_NEW:
                to_add.append((pend_idx, est))
        return to_merge, to_add

    def _merge_pending(self, to_merge: List[Tuple[int, int]]) -> List[int]:
        """mergePending: fold pending observations + appearance into the
        existing object."""
        removed = []
        for pend_idx, obj_id in to_merge:
            pend = self.pending[pend_idx]
            self.ltm_merges += obj_id in self.pg.ltm_object_ids
            for obs in pend.observations:
                self.pg.add_object_observation(
                    obj_id, obs.frame_id, obs.camera_id, obs.corners, obs.covariance
                )
            appearance = self.object_appearance.setdefault(obj_id, {})
            for fr, cams in pend.observed_feats.items():
                for cam, featset in cams.items():
                    appearance.setdefault(fr, {})[cam] = featset
            removed.append(pend_idx)
        return removed

    # ------------------------------------------------------------------
    def _cleanup(self, frame_id):
        """cleanupBbAssociationRound: stale-pending discard + feature-window
        expiry (feature_based...h:507-571)."""
        if self.params.discard_candidate_after_num_frames > 0:
            self.pending = [
                p
                for p in self.pending
                if frame_id <= p.max_frame_id + self.params.discard_candidate_after_num_frames
            ]
        window = self.params.feature_validity_window
        for pend in self.pending:
            pend.observed_feats = {
                fr: cams
                for fr, cams in pend.observed_feats.items()
                if fr + window >= frame_id
            }
        for obj_id in list(self.object_appearance):
            self.object_appearance[obj_id] = {
                fr: cams
                for fr, cams in self.object_appearance[obj_id].items()
                if fr + window >= frame_id
            }

    # ------------------------------------------------------------------
    def get_front_end_obj_map_data(self) -> Dict[int, dict]:
        """getFrontEndObjMapData: feature-based payload is empty per object."""
        return {obj_id: {} for obj_id in self.pg.objects}


def merge_objects_by_center_proximity(
    pg: PoseGraph, max_distance: float, x_y_only: bool
) -> Dict[int, Set[int]]:
    """identifyMergeObjectsBasedOnCenterProximity
    (bounding_box_front_end_helpers.h:267-356): greedy same-class pairwise
    center-distance matching; never merges two LTM objects; LTM object always
    survives. Returns {surviving: {merged...}}."""
    if max_distance < 0:
        return {}
    by_class: Dict[str, List[Tuple[int, np.ndarray]]] = {}
    for obj_id, node in pg.objects.items():
        by_class.setdefault(node.semantic_class, []).append(
            (obj_id, node.ellipsoid[:3])
        )
    candidates = []
    for cls, objs in by_class.items():
        for i in range(len(objs)):
            for j in range(i + 1, len(objs)):
                a, pa = objs[i]
                b, pb = objs[j]
                if a in pg.ltm_object_ids and b in pg.ltm_object_ids:
                    continue
                d = (
                    np.linalg.norm(pa[:2] - pb[:2])
                    if x_y_only
                    else np.linalg.norm(pa - pb)
                )
                if d <= max_distance:
                    candidates.append((d, a, b))
    candidates.sort()
    involved = set()
    results: Dict[int, Set[int]] = {}
    for d, a, b in candidates:
        if a in involved or b in involved:
            continue
        involved.add(a)
        involved.add(b)
        if a in pg.ltm_object_ids:
            results.setdefault(a, set()).add(b)
        else:
            results.setdefault(b, set()).add(a)
    return results


def apply_merges(pg: PoseGraph, merge_results: Dict[int, Set[int]], frontend=None) -> bool:
    """Execute merges in the pose graph (+ frontend appearance folding)."""
    merged_any = False
    for keep, removes in merge_results.items():
        for remove in removes:
            if keep not in pg.objects or remove not in pg.objects:
                continue
            if frontend is not None:
                frontend.ltm_merges += keep in pg.ltm_object_ids
                app = frontend.object_appearance.pop(remove, {})
                target = frontend.object_appearance.setdefault(keep, {})
                for fr, cams in app.items():
                    for cam, featset in cams.items():
                        target.setdefault(fr, {})[cam] = featset
            pg.merge_objects(remove, keep)
            merged_any = True
    return merged_any
