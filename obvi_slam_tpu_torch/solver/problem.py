"""Window problem builder: pose graph -> padded device tables.

Counterpart of ``obvi_slam_tpu/solver/problem.py`` for the visual-only
runner: each window is gathered from the host pose graph into
capacity-bucketed ``FactorTables`` and a ``SchurPlan`` on ``device``.
Scope-dependent inclusion (min-observation thresholds, feature-starved
relpose gating, LTM handling) is expressed as 0/1 ``FactorWeights``, so the
two phases of a window iteration share one problem.

Selection rules, as in the reference:
  - visual factors with frames in [min, max]; features kept only with
    >= min_low_level_feature_observations factors in scope
  - relpose factors only for frames with < min_..._per_frame live feature
    observations
  - object observation factors in scope; objects kept with
    >= min_object_observations or LTM membership
  - object-only factors (shape prior / LTM prior) for included objects;
    force_include_ltm_objs adds all LTM objects
  - constant poses: frame 0 when the window starts at 0, else the first
    max(1, poses_prior_to_window_to_keep_constant) window frames

Capacities are pinned minimums (``caps``, a session pool grown with
``update_caps_pool``), so the port's tables and plans equal the reference
runner's. PGO passes its synthesized relative-pose chain and relpose Huber
delta (``synthesized_relpose``, ``relpose_huber_override``). Not ported:
host-only builds and the row registry of the reference's device diff-sync.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch import types as T
from obvi_slam_tpu_torch.pose_graph import (
    OBJECT_OBSERVATION_FACTOR,
    RELATIVE_POSE_FACTOR,
    REPROJECTION_FACTOR,
    PoseGraph,
    batched_sqrt_inf,
)
from obvi_slam_tpu_torch.solver.plan import SchurPlan, build_schur_plan_host
from obvi_slam_tpu_torch.solver.schur import FactorWeights, HuberParams
from obvi_slam_tpu_torch.solver.two_phase import TwoPhaseAux

PLAN_CAP_KEYS = (
    "pt_pair", "pt_cross", "pt_dest", "pt_slot_land", "pt_slot_c", "ob_pair", "ob_cross",
    "ob_dest", "ob_slot_land", "ob_slot_c", "pt_band_lg", "rel_band_lg",
)


@dataclass
class Scope:
    """OptimizationScopeParams mirror."""

    min_frame_id: int
    max_frame_id: int
    include_object_factors: bool = True
    include_visual_factors: bool = True
    fix_poses: bool = False
    fix_objects: bool = False
    fix_visual_features: bool = False
    fix_ltm_objects: bool = False
    poses_prior_to_window_to_keep_constant: int = 1
    min_object_observations: int = 1
    min_low_level_feature_observations: int = 3
    min_low_level_feature_observations_per_frame: int = 50
    force_include_ltm_objs: bool = False
    include_shape_priors: bool = True  # excluded during LTM extraction


def _bucket(n: int, minimum=16) -> int:
    """Next power of two >= n (the reference's capacity buckets)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


@dataclass
class Problem:
    """A gathered window: device tensors + host index maps."""

    state: T.BAState
    cams: T.CameraBundle
    tables: T.FactorTables
    plan: SchurPlan
    free: T.FreeMasks
    weights: FactorWeights
    huber: HuberParams
    # Host index maps (row -> pose-graph id).
    pose_rows: np.ndarray  # frame ids
    point_rows: np.ndarray  # feature ids
    obj_rows: np.ndarray  # object ids
    reproj_rows: np.ndarray  # visual factor ids (pg indices)
    bbox_rows: np.ndarray  # object observation factor ids
    relpose_rows: np.ndarray
    shape_rows: np.ndarray
    ltm_rows: np.ndarray
    scope: Scope = None
    # numpy copies of weight vectors (pre-exclusion), for the outlier pass
    base_weights_np: dict = field(default_factory=dict)
    # The two-phase re-selection's per-object LTM membership and shape-prior
    # tombstone mask.
    aux: TwoPhaseAux = None


def _camera_arrays(pg: PoseGraph, dtype):
    """Sorted camera ids (the bundle's rows) and the per-camera arrays
    (extrinsics, fx, fy, cx, cy), the intrinsics in ``dtype``."""
    cam_ids = sorted(pg.cameras)
    cams = [pg.cameras[c] for c in cam_ids]
    r = np.stack([c.extrinsics_r for c in cams])
    t = np.stack([c.extrinsics_t for c in cams])
    k = [np.array([c.intrinsics[i, j] for c in cams]).astype(dtype)
         for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))]
    return cam_ids, (r, t, *k)


def camera_bundle_from_pose_graph(pg: PoseGraph, dtype=np.float64, device="cuda"):
    """The pose graph's cameras as a CameraBundle on ``device`` (rows in
    sorted camera-id order) and the camera id -> row map."""
    cam_ids, arrays = _camera_arrays(pg, dtype)
    cams = T.make_camera_bundle(*arrays, dtype=dtype, device=device)
    return cams, {c: i for i, c in enumerate(cam_ids)}


def compute_inclusion_weights(
    pg: PoseGraph,
    scope: Scope,
    reproj_rows: np.ndarray,
    bbox_rows: np.ndarray,
    relpose_rows: np.ndarray,
    shape_rows: np.ndarray,
    ltm_rows: np.ndarray,
    excluded: Optional[Set[Tuple[int, int]]] = None,
):
    """0/1 weights implementing the reference's factor-selection rules over
    the pose graph's columnar factor views (host numpy).

    ``excluded``: set of (factor_type, pg_factor_id) outliers (two-phase)."""
    excluded = excluded or set()

    def excluded_ids(ftype):
        return np.asarray([fid for t, fid in excluded if t == ftype], dtype=np.int64)

    vf = pg.visual_factor_columns()
    rp_w = np.ones(len(reproj_rows))
    exc = excluded_ids(REPROJECTION_FACTOR)
    if len(exc):
        rp_w[np.isin(reproj_rows, exc)] = 0.0
    # Min observations per feature (count of live factors in scope), over a
    # compact feature index (np.unique's inverse).
    rp_feat = vf["feature_id"][reproj_rows]
    _, feat_inv = np.unique(rp_feat, return_inverse=True)
    live = rp_w > 0
    feat_count = np.bincount(
        feat_inv[live], minlength=feat_inv.max() + 1 if len(feat_inv) else 0
    )
    if len(reproj_rows):
        rp_w[live & (feat_count[feat_inv] < scope.min_low_level_feature_observations)] = 0.0
    if not scope.include_visual_factors:
        rp_w[:] = 0.0

    # Relpose: only for feature-starved frames (count live factor rows by frame).
    use_relpose = (
        scope.min_low_level_feature_observations_per_frame > 0
        and scope.include_visual_factors
    )
    rl_w = np.zeros(len(relpose_rows))
    if use_relpose and len(relpose_rows):
        rp_frame = vf["frame_id"][reproj_rows]
        live = rp_w > 0
        span = scope.max_frame_id - scope.min_frame_id + 1
        in_span = live & (rp_frame >= scope.min_frame_id) & (rp_frame <= scope.max_frame_id)
        frame_obs = np.bincount(rp_frame[in_span] - scope.min_frame_id, minlength=span)
        starved = frame_obs < scope.min_low_level_feature_observations_per_frame

        def frame_starved(fr):
            rel = fr - scope.min_frame_id
            return (rel >= 0) & (rel < span) & starved[np.clip(rel, 0, span - 1)]

        rl = pg.relpose_factor_columns()
        rl_w[frame_starved(rl["before"][relpose_rows])
             | frame_starved(rl["after"][relpose_rows])] = 1.0
        exc = excluded_ids(RELATIVE_POSE_FACTOR)
        if len(exc):
            rl_w[np.isin(relpose_rows, exc)] = 0.0

    # Objects: min observations or LTM membership.
    oo = pg.object_observation_columns()
    bb_w = np.ones(len(bbox_rows))
    exc = excluded_ids(OBJECT_OBSERVATION_FACTOR)
    if len(exc):
        bb_w[np.isin(bbox_rows, exc)] = 0.0
    included_objects = set()
    if len(bbox_rows):
        bb_obj = oo["object_id"][bbox_rows]
        uniq_obj, obj_inv = np.unique(bb_obj, return_inverse=True)
        obj_count = np.bincount(obj_inv[bb_w > 0], minlength=len(uniq_obj))
        is_ltm = np.array([o in pg.ltm_object_ids for o in uniq_obj])
        # An object needs >= 1 live observation to be included at all.
        obj_included = ((obj_count >= scope.min_object_observations) | is_ltm) & (
            obj_count > 0
        )
        included_objects = set(uniq_obj[obj_included].tolist())
        bb_w[(bb_w > 0) & ~obj_included[obj_inv]] = 0.0
    if not scope.include_object_factors:
        bb_w[:] = 0.0
        included_objects = set()

    # Object-only factors for included objects.
    use_object_only = scope.include_object_factors and not scope.fix_objects
    fix_ltm = scope.fix_objects or scope.fix_ltm_objects
    objs_with_object_only = set()
    if use_object_only:
        if fix_ltm:
            objs_with_object_only = {
                o for o in included_objects if o not in pg.ltm_object_ids
            }
        else:
            objs_with_object_only = set(included_objects)
            if scope.force_include_ltm_objs:
                objs_with_object_only |= pg.ltm_object_ids
    oo_arr = np.fromiter(objs_with_object_only, dtype=np.int64, count=len(objs_with_object_only))
    sh_w = np.zeros(len(shape_rows))
    if scope.include_shape_priors and len(shape_rows):
        sp_obj = pg.shape_prior_columns()["object_id"][shape_rows]
        sh_w[np.isin(sp_obj, oo_arr)] = 1.0  # tombstones are -1, never match
    lt_w = np.zeros(len(ltm_rows))
    if len(ltm_rows):
        lt_obj = pg.ltm_factor_columns()["object_id"][ltm_rows]
        lt_w[np.isin(lt_obj, oo_arr)] = 1.0

    return rp_w, bb_w, sh_w, rl_w, lt_w, included_objects, objs_with_object_only


def _rows_of(row_ids, ids):
    """Table row of each id (``row_ids``: the id of each row, sorted);
    raises KeyError for an id without a row."""
    ids = np.asarray(ids)
    if len(ids) == 0:
        return np.zeros(0, dtype=np.int64)
    if len(row_ids) == 0:
        raise KeyError(
            f"factors reference ids {np.unique(ids)[:10].tolist()} but the "
            "window has no rows of that kind"
        )
    row_ids = np.asarray(row_ids, dtype=np.int64)
    order = np.argsort(row_ids, kind="stable")
    sorted_ids = row_ids[order]
    clipped = np.minimum(np.searchsorted(sorted_ids, ids), len(sorted_ids) - 1)
    bad = sorted_ids[clipped] != ids
    if bad.any():
        raise KeyError(
            f"factor references ids absent from the window tables: "
            f"{np.unique(ids[bad])[:10].tolist()}"
        )
    return order[clipped].astype(np.int64)


def _weight_vectors(weights_np, caps, dtype, device):
    def padv(v, cap):
        out = np.zeros(cap, dtype=dtype)
        out[: len(v)] = v
        return torch.from_numpy(out).to(device)

    return FactorWeights(*(padv(v, cap) for v, cap in zip(weights_np, caps)))


def build_problem(
    pg: PoseGraph,
    scope: Scope,
    residual_params=None,
    excluded: Optional[Set[Tuple[int, int]]] = None,
    dtype=np.float64,
    caps: Optional[dict] = None,
    synthesized_relpose: Optional[list] = None,
    relpose_huber_override: Optional[float] = None,
    device="cuda",
) -> Problem:
    """Gather the window into tables on ``device``.

    ``residual_params``: config.ResidualParams for the Huber deltas
    (optional). ``caps``: pinned minimum capacities (table capacities,
    n_pose / n_point / n_obj and the plan's ``PLAN_CAP_KEYS``).
    ``synthesized_relpose``: (before_frame, after_frame, rel_pose6, cov6x6)
    tuples that replace the pose graph's relpose factors (PGO's chain from
    the current estimates), all live. ``relpose_huber_override``: PGO's own
    relpose Huber delta."""
    return _build_problem_impl(
        pg, scope, residual_params, excluded, dtype, caps, synthesized_relpose,
        relpose_huber_override, device,
    )


def _build_problem_impl(
    pg, scope, residual_params, excluded, dtype, caps, synthesized_relpose,
    relpose_huber_override, device,
) -> Problem:
    cam_ids, cam_arrays = _camera_arrays(pg, dtype)
    cams = T.make_camera_bundle(*cam_arrays, dtype=dtype, device=device)
    fx, fy, cx, cy = cam_arrays[2:]

    frames = [f for f in pg.frame_ids() if scope.min_frame_id <= f <= scope.max_frame_id]
    pose_row_of = {f: i for i, f in enumerate(frames)}

    # --- factor rows in scope (all candidates; inclusion via weights) ------
    lo, hi = scope.min_frame_id, scope.max_frame_id
    reproj_rows = np.array(pg.visual_factor_ids_in_window(lo, hi), dtype=np.int64)
    bbox_rows = np.array(pg.obj_obs_ids_in_window(lo, hi), dtype=np.int64)
    if synthesized_relpose is None:
        relpose_rows = np.array(pg.relpose_ids_in_window(lo, hi), dtype=np.int64)
    else:
        relpose_rows = np.array([], dtype=np.int64)

    # Landmark rows: every feature/object referenced by a candidate factor.
    vf_cols = pg.visual_factor_columns()
    oo_cols = pg.object_observation_columns()
    feat_ids = np.unique(vf_cols["feature_id"][reproj_rows]).tolist()
    cur_obj = set(np.unique(oo_cols["object_id"][bbox_rows]).tolist())
    if scope.force_include_ltm_objs:
        cur_obj |= pg.ltm_object_ids
    obj_ids = sorted(cur_obj)
    obj_row_of = {o: i for i, o in enumerate(obj_ids)}

    # Object-only factor rows for the candidate objects.
    shape_rows = np.array(
        sorted(s for o in obj_ids for s in pg.shape_priors_by_object.get(o, [])), dtype=np.int64
    )
    ltm_rows = np.array(
        sorted(f for o in obj_ids for f in pg.ltm_factors_by_object.get(o, [])), dtype=np.int64
    )

    # --- inclusion weights -------------------------------------------------
    rp_w, bb_w, sh_w, rl_w, lt_w, _, _ = compute_inclusion_weights(
        pg, scope, reproj_rows, bbox_rows, relpose_rows, shape_rows, ltm_rows, excluded
    )
    if synthesized_relpose is not None:
        rl_w = np.ones(len(synthesized_relpose))

    # Pinned caps are minimums; the window's actual needs always win.
    caps = dict(caps or {})
    rp_cap = max(caps.get("reproj", 0), _bucket(len(reproj_rows)))
    bb_cap = max(caps.get("bbox", 0), _bucket(len(bbox_rows)))
    sh_cap = max(caps.get("shape", 0), _bucket(len(shape_rows)))
    rl_cap = max(caps.get("relpose", 0), _bucket(len(rl_w)))
    lt_cap = max(caps.get("ltm", 0), _bucket(len(ltm_rows)))

    # --- state arrays ------------------------------------------------------
    # Padding rows are zeros with free=False: no factor references them,
    # their H blocks hit the singular guard, and write-back skips them.
    pose_cap = max(caps.get("n_pose", 0), _bucket(max(len(frames), 1), minimum=8))
    point_cap = max(caps.get("n_point", 0), _bucket(max(len(feat_ids), 1)))
    obj_cap = max(caps.get("n_obj", 0), _bucket(max(len(obj_ids), 1), minimum=8))

    def pad_rows(rows, cap, width):
        out = np.zeros((cap, width))
        if len(rows):
            out[: len(rows)] = np.stack(rows)
        return torch.from_numpy(out.astype(dtype)).to(device)

    state = T.BAState(
        poses=pad_rows([pg.robot_poses[f] for f in frames], pose_cap, 6),
        points=pad_rows([pg.features[f] for f in feat_ids], point_cap, 3),
        objects=pad_rows(
            [pg.objects[o].ellipsoid if o in pg.objects else np.zeros(7) for o in obj_ids],
            obj_cap, 7,
        ),
    )

    frames_arr = np.asarray(frames, dtype=np.int64)
    feat_arr = np.asarray(feat_ids, dtype=np.int64)
    obj_arr = np.asarray(obj_ids, dtype=np.int64)
    cam_arr = np.asarray(cam_ids, dtype=np.int64)

    # --- reprojection table ------------------------------------------------
    rp_pose = _rows_of(frames_arr, vf_cols["frame_id"][reproj_rows])
    rp_point = _rows_of(feat_arr, vf_cols["feature_id"][reproj_rows])
    rp_cam = _rows_of(cam_arr, vf_cols["camera_id"][reproj_rows])
    px = vf_cols["pixel"][reproj_rows].reshape(-1, 2)
    std = vf_cols["std"][reproj_rows]
    rp_obs = np.stack(
        [(px[:, 0] - cx[rp_cam]) / fx[rp_cam], (px[:, 1] - cy[rp_cam]) / fy[rp_cam]], axis=1
    )
    rp_mult = np.stack([fx[rp_cam] / std, fy[rp_cam] / std], axis=1)
    reproj = T.make_reprojection_factors(
        rp_pose, rp_point, rp_cam, rp_obs, rp_mult, capacity=rp_cap, dtype=dtype, device=device
    )

    # --- bbox table --------------------------------------------------------
    bb_obj = _rows_of(obj_arr, oo_cols["object_id"][bbox_rows])
    bb_pose = _rows_of(frames_arr, oo_cols["frame_id"][bbox_rows])
    bb_cam = _rows_of(cam_arr, oo_cols["camera_id"][bbox_rows])
    crn = oo_cols["corners"][bbox_rows].reshape(-1, 4)
    bb_corners = np.stack(
        [
            (crn[:, 0] - cx[bb_cam]) / fx[bb_cam],
            (crn[:, 1] - cx[bb_cam]) / fx[bb_cam],
            (crn[:, 2] - cy[bb_cam]) / fy[bb_cam],
            (crn[:, 3] - cy[bb_cam]) / fy[bb_cam],
        ],
        axis=1,
    )
    # sqrt-information times the rectification scale diag(fx, fx, fy, fy).
    scale_cols = np.stack([fx[bb_cam], fx[bb_cam], fy[bb_cam], fy[bb_cam]], axis=1)
    bb_si = oo_cols["sqrt_inf"][bbox_rows].reshape(-1, 4, 4) * scale_cols[:, None, :]
    bbox = T.make_bounding_box_factors(
        bb_obj, bb_pose, bb_cam, bb_corners, bb_si, capacity=bb_cap, dtype=dtype, device=device
    )

    # --- shape prior table -------------------------------------------------
    sp_cols = pg.shape_prior_columns()
    shape = T.make_shape_prior_factors(
        _rows_of(obj_arr, np.maximum(sp_cols["object_id"][shape_rows], 0)),
        sp_cols["mean"][shape_rows].reshape(-1, 3),
        sp_cols["sqrt_inf"][shape_rows].reshape(-1, 3, 3),
        capacity=sh_cap, dtype=dtype, device=device,
    )

    # --- relpose table -----------------------------------------------------
    if synthesized_relpose is None:
        rl_cols = pg.relpose_factor_columns()
        rl_b_ids = rl_cols["before"][relpose_rows]
        rl_a_ids = rl_cols["after"][relpose_rows]
        rl_t = rl_cols["rel_t"][relpose_rows].reshape(-1, 3)
        rl_r = rl_cols["rel_r"][relpose_rows].reshape(-1, 3, 3)
        rl_si = rl_cols["sqrt_inf"][relpose_rows].reshape(-1, 6, 6)
    else:
        rl_b_ids = np.array([s[0] for s in synthesized_relpose], dtype=np.int64)
        rl_a_ids = np.array([s[1] for s in synthesized_relpose], dtype=np.int64)
        rel = np.array([s[2] for s in synthesized_relpose], dtype=np.float64).reshape(-1, 6)
        covs = np.array([s[3] for s in synthesized_relpose], dtype=np.float64).reshape(
            -1, 6, 6
        )
        rl_t = rel[:, :3]
        rl_r = (
            Rotation.from_rotvec(rel[:, 3:6]).as_matrix().reshape(-1, 3, 3)
            if len(rel) else np.zeros((0, 3, 3))
        )
        rl_si = batched_sqrt_inf(covs)
    rl_before = _rows_of(frames_arr, rl_b_ids)
    rl_after = _rows_of(frames_arr, rl_a_ids)
    relpose = T.make_relative_pose_factors(
        rl_before, rl_after, rl_t, rl_r, rl_si, capacity=rl_cap, dtype=dtype, device=device,
    )

    # --- LTM prior table ---------------------------------------------------
    lt_cols = pg.ltm_factor_columns()
    ltm = T.make_ltm_prior_factors(
        _rows_of(obj_arr, lt_cols["object_id"][ltm_rows]),
        lt_cols["mean"][ltm_rows].reshape(-1, 7),
        lt_cols["sqrt_inf"][ltm_rows].reshape(-1, 7, 7),
        capacity=lt_cap, dtype=dtype, device=device,
    )

    tables = T.FactorTables(
        reproj=reproj, bbox=bbox, shape=shape, relpose=relpose, ltm=ltm,
        param_prior=T.empty_param_prior_factors(dtype=dtype, device=device),
    )

    # --- free masks --------------------------------------------------------
    pose_free = np.zeros(pose_cap, dtype=bool)
    pose_free[: len(frames)] = not scope.fix_poses
    if not scope.fix_poses:
        if scope.min_frame_id == 0:
            if 0 in pose_row_of:
                pose_free[pose_row_of[0]] = False
        else:
            for k in range(max(1, scope.poses_prior_to_window_to_keep_constant)):
                fr = scope.min_frame_id + k
                if fr in pose_row_of:
                    pose_free[pose_row_of[fr]] = False
    point_free = np.zeros(point_cap, dtype=bool)
    point_free[: len(feat_ids)] = not scope.fix_visual_features
    obj_free = np.zeros(obj_cap, dtype=bool)
    obj_free[: len(obj_ids)] = not scope.fix_objects
    if not scope.fix_objects and scope.fix_ltm_objects:
        for o in obj_ids:
            if o in pg.ltm_object_ids:
                obj_free[obj_row_of[o]] = False

    def dev(x):
        return torch.from_numpy(x).to(device)

    free = T.FreeMasks(poses=dev(pose_free), points=dev(point_free), objects=dev(obj_free))

    weights_np = (rp_w, bb_w, sh_w, rl_w, lt_w)
    weights = _weight_vectors(weights_np, (rp_cap, bb_cap, sh_cap, rl_cap, lt_cap), dtype, device)

    plan = build_schur_plan_host(
        rp_pose, rp_point, rp_cap, bb_pose, bb_obj, bb_cap,
        {k: caps[k] for k in PLAN_CAP_KEYS if k in caps} or None,
        n_pose=pose_cap, rl_before=rl_before, rl_after=rl_after, rl_cap=rl_cap,
        device=device,
    )

    is_ltm = np.zeros(obj_cap, dtype=bool)
    for o in obj_ids:
        if o in pg.ltm_object_ids:
            is_ltm[obj_row_of[o]] = True
    shape_live = np.zeros(sh_cap, dtype=bool)
    if len(shape_rows):
        shape_live[: len(shape_rows)] = sp_cols["object_id"][shape_rows] >= 0
    aux = TwoPhaseAux(is_ltm_obj=dev(is_ltm), shape_live=dev(shape_live))

    if residual_params is not None:
        obj_params = residual_params.object_residual_params
        huber = HuberParams(
            reproj=residual_params.reprojection_error_huber_loss_param,
            bbox=obj_params.object_observation_huber_loss_param,
            shape=obj_params.shape_dim_prior_factor_huber_loss_param,
            relpose=(
                residual_params.relative_pose_factor_huber_loss
                if relpose_huber_override is None else relpose_huber_override
            ),
            ltm=residual_params.ltm_pair_huber_loss_param,
            invalid_ellipse_error=obj_params.invalid_ellipsoid_error_val,
        )
    else:
        huber = HuberParams(relpose=1.0 if relpose_huber_override is None
                            else relpose_huber_override)

    return Problem(
        state=state, cams=cams, tables=tables, plan=plan, free=free, weights=weights,
        huber=huber, aux=aux,
        pose_rows=np.array(frames, dtype=np.int64),
        point_rows=np.array(feat_ids, dtype=np.int64),
        obj_rows=np.array(obj_ids, dtype=np.int64),
        reproj_rows=reproj_rows, bbox_rows=bbox_rows, relpose_rows=relpose_rows,
        shape_rows=shape_rows, ltm_rows=ltm_rows, scope=scope,
        base_weights_np=dict(zip(("reproj", "bbox", "shape", "relpose", "ltm"), weights_np)),
    )


def observed_caps(problem: Problem) -> Dict[str, int]:
    """The capacities a built Problem used, as a caps dict. The runner
    max-accumulates them into a session pool and passes the pool back as
    ``caps``, so capacities only grow within a session, as the reference's
    runner does."""
    p, t = problem.plan, problem.tables
    return {
        "reproj": t.reproj.mask.shape[0],
        "bbox": t.bbox.mask.shape[0],
        "shape": t.shape.mask.shape[0],
        "relpose": t.relpose.mask.shape[0],
        "ltm": t.ltm.mask.shape[0],
        "n_pose": problem.state.poses.shape[0],
        "n_point": problem.state.points.shape[0],
        "n_obj": problem.state.objects.shape[0],
        "pt_pair": p.pt_pair_pose.shape[0],
        "pt_cross": p.pt_cross_a.shape[0],
        "pt_dest": p.pt_dest_a.shape[0],
        "pt_slot_land": p.pt_slot_gather.shape[0],
        "pt_slot_c": p.pt_slot_gather.shape[1],
        "ob_pair": p.ob_pair_pose.shape[0],
        "ob_cross": p.ob_cross_a.shape[0],
        "ob_dest": p.ob_dest_a.shape[0],
        "ob_slot_land": p.ob_slot_gather.shape[0],
        "ob_slot_c": p.ob_slot_gather.shape[1],
        "pt_band_lg": 0 if p.pt_band_local_pose is None else p.pt_band_local_pose.shape[1],
        "rel_band_lg": 0 if p.rel_band_local_pose is None else p.rel_band_local_pose.shape[1],
    }


def update_caps_pool(pool: dict, problem: Problem) -> dict:
    """Max-accumulate a Problem's observed capacities into ``pool``."""
    for k, v in observed_caps(problem).items():
        pool[k] = max(pool.get(k, 0), int(v))
    return pool


def reweight_for_exclusions(
    pg: PoseGraph, problem: Problem, excluded: Set[Tuple[int, int]]
) -> FactorWeights:
    """Phase-2 weights: inclusion recomputed with the outliers removed (the
    reference rebuilds its problem with the exclusion set; only the weight
    vectors change)."""
    weights_np = compute_inclusion_weights(
        pg, problem.scope, problem.reproj_rows, problem.bbox_rows, problem.relpose_rows,
        problem.shape_rows, problem.ltm_rows, excluded,
    )[:5]
    t = problem.tables
    caps = (t.reproj.capacity, t.bbox.capacity, t.shape.capacity, t.relpose.capacity,
            t.ltm.capacity)
    dtype = torch.empty(0, dtype=problem.state.poses.dtype).numpy().dtype
    return _weight_vectors(weights_np, caps, dtype, problem.state.poses.device)


def write_back(pg: PoseGraph, problem: Problem, state: T.BAState):
    """Write optimized values of free blocks back into the pose graph.
    Returns the host (poses, points, objects)."""
    host = [x.detach().cpu().numpy() for x in (*state, *problem.free)]
    poses, points, objects, pose_free, point_free, obj_free = host
    for i, frame in enumerate(problem.pose_rows):
        if pose_free[i]:
            pg.robot_poses[int(frame)] = poses[i].copy()
    for i, feat in enumerate(problem.point_rows):
        if point_free[i]:
            pg.features[int(feat)] = points[i].copy()
    for i, obj in enumerate(problem.obj_rows):
        if obj_free[i]:
            pg.objects[int(obj)].ellipsoid = objects[i].copy()
    return poses, points, objects
