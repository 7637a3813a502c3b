"""Long-term object map: extraction, serialization, next-session seeding.

Counterpart of ``obvi_slam_tpu/ltm.py`` (the reference's LTM subsystem):

  extraction (end of session):
    - drop features whose min distance to any observing pose exceeds
      ``far_feature_threshold`` (75m)
    - full-trajectory problem with shape priors EXCLUDED and LTM objects
      force-included
    - per-object 7x7 marginal covariance from the undamped robustified
      Hessian (``solver.schur.compute_marginal_covariances`` on ``device``:
      point elimination and a dense inverse)
    - rank deficiency repair: null directions of the reduced Hessian get
      weak scalar priors with 1/std = sqrt(min_col_norm - col_norm), then
      retry; covariance blocks that are still not PSD are recomputed from
      a clamped eigendecomposition (host numpy, f64)
    - on failure, fall back to the previous session's map

  next session:
    - LTM ellipsoids pre-inserted in the pose graph with known ids and one
      unary prior factor per LTM object

The JSON format is the reference's: a map saved by either package loads in
the other.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import torch

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch import types as T
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.solver.problem import Scope, build_problem
from obvi_slam_tpu_torch.solver.schur import compute_marginal_covariances
from obvi_slam_tpu_torch.timing import timer

logger = logging.getLogger(__name__)


@dataclass
class LongTermObjectMap:
    """The reference's IndependentEllipsoidsLongTermObjectMap."""

    # obj_id -> (semantic_class, ellipsoid 7-vec)
    ellipsoids: Dict[int, tuple] = field(default_factory=dict)
    # obj_id -> 7x7 covariance
    covariances: Dict[int, np.ndarray] = field(default_factory=dict)
    # obj_id -> frontend appearance payload (empty dict for feature-based FE)
    front_end_data: Dict[int, dict] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "ellipsoids": {
                str(k): [cls, np.asarray(e).tolist()]
                for k, (cls, e) in self.ellipsoids.items()
            },
            "covariances": {
                str(k): np.asarray(c).tolist() for k, c in self.covariances.items()
            },
            "front_end_data": {str(k): v for k, v in self.front_end_data.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "LongTermObjectMap":
        return cls(
            ellipsoids={
                int(k): (v[0], np.array(v[1])) for k, v in d["ellipsoids"].items()
            },
            covariances={
                int(k): np.array(v) for k, v in d["covariances"].items()
            },
            front_end_data={int(k): v for k, v in d["front_end_data"].items()},
        )

    def save(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "LongTermObjectMap":
        with open(path) as f:
            return cls.from_json(json.load(f))


def far_feature_ids(pg: PoseGraph, threshold: float):
    """Features whose MIN distance to any observing pose exceeds threshold."""
    far = set()
    for feat_id, pos in pg.features.items():
        min_dist = np.inf
        for fid in pg.visual_factors_by_feature.get(feat_id, []):
            frame = pg.visual_factors[fid].frame_id
            pose = pg.get_robot_pose(frame)
            if pose is None:
                continue
            min_dist = min(min_dist, float(np.linalg.norm(pos - pose[:3])))
        if min_dist > threshold:
            far.add(feat_id)
    return far


def find_rank_deficiencies(red_h, state_np, min_col_norm):
    """Null-space identification on the reduced (poses+objects) Hessian.

    Eigendecomposes the symmetric reduced Hessian H = J^T J (points already
    eliminated) and treats eigenvectors of near-zero eigenvalues as the null
    space, which also finds deficiencies that are linear combinations of
    columns (a pose observed only through one bounding-box factor). An
    eigendirection is deficient when sqrt(lambda), the Jacobian column norm
    along it, is below ``min_col_norm``, or when lambda is numerically zero
    relative to the spectrum. Each participating parameter (|v_i| above 10%
    of the eigenvector's max) gets a weak scalar prior with the reference's
    repair strength 1/std = sqrt(min_col_norm - col_norm), floored at
    sqrt(min_col_norm/2).

    Host numpy in f64. Returns [(kind_code, row, param_idx, mean, inv_std)].
    """
    dim = red_h.shape[0]
    n_pose = state_np["pose"].shape[0]
    lam, vec = np.linalg.eigh(0.5 * (red_h + red_h.T))
    lam_max = float(lam[-1]) if dim else 0.0
    thr = max(min_col_norm**2, lam_max * 1e-12)
    deficient = {}
    for k in range(dim):
        if lam[k] >= thr:
            break
        col_norm = float(np.sqrt(max(lam[k], 0.0)))
        inv_std = float(
            np.sqrt(max(min_col_norm - col_norm, 0.5 * min_col_norm))
        )
        v = np.abs(vec[:, k])
        involved = np.nonzero(v > 0.1 * v.max())[0]
        for idx in involved:
            idx = int(idx)
            if idx < n_pose * 6:
                key = (0, idx // 6, idx % 6)
                mean = float(state_np["pose"][idx // 6, idx % 6])
            else:
                o = idx - n_pose * 6
                key = (2, o // 7, o % 7)
                mean = float(state_np["object"][o // 7, o % 7])
            # Strongest repair wins if a param joins several null directions.
            prev = deficient.get(key)
            if prev is None or prev[1] < inv_std:
                deficient[key] = (mean, inv_std)
    return [
        (k[0], k[1], k[2], mean, inv_std)
        for k, (mean, inv_std) in sorted(deficient.items())
    ]


def extract_long_term_object_map(
    pg: PoseGraph,
    config: cfg.FullOVSLAMConfig,
    front_end_data: Optional[Dict[int, dict]] = None,
    prev_ltm: Optional[LongTermObjectMap] = None,
    dtype=np.float64,
    caps: Optional[dict] = None,
    device="cuda",
    plain: bool = False,
) -> Optional[LongTermObjectMap]:
    """The reference's extractLongTermObjectMap on ``device``.

    ``caps``: pinned minimum capacities of the extraction problem (e.g. the
    runner's "global" pool). ``plain``: the kernels' plain versions."""
    with timer("ltm_extraction"):
        ltm = _extract(pg, config, front_end_data, dtype, caps, device, plain)
    if ltm is None:
        if (
            config.ltm_tunable_params.fallback_to_prev_for_failed_extraction
            and prev_ltm is not None
        ):
            logger.warning("LTM extraction failed; falling back to previous map")
            return prev_ltm
        return None
    return ltm


def _extraction_scope(max_frame, config) -> Scope:
    """The extraction problem's scope: whole trajectory, shape priors
    excluded, LTM objects force-included."""
    en = config.optimization_factors_enabled_params
    return Scope(
        min_frame_id=0,
        max_frame_id=max_frame,
        include_object_factors=True,
        include_visual_factors=True,
        poses_prior_to_window_to_keep_constant=en.poses_prior_to_window_to_keep_constant,
        min_object_observations=en.min_object_observations,
        min_low_level_feature_observations=en.min_low_level_feature_observations,
        min_low_level_feature_observations_per_frame=en.min_low_level_feature_observations_per_frame,
        force_include_ltm_objs=True,
        include_shape_priors=False,
    )


def _ensure_psd_covs(covs, red_h, n_pose, min_col_norm):
    """Guarantee PSD object covariance blocks before they are serialized.

    When the reduced system is rank-deficient past what the repair
    identified, its dense inverse has large mixed-sign eigenvalues, and
    whitening it (pose_graph.batched_sqrt_inf) would raise when the next
    session seeds from the map. If any block is non-PSD beyond f64 roundoff,
    all object blocks are recomputed from the reduced Hessian's
    eigendecomposition with near-null eigenvalues clamped to min_col_norm**2
    (priors of strength min_col_norm on exactly the null directions), PSD
    by construction. Host numpy, f64."""
    if covs.size == 0:
        return covs
    finite = np.all(np.isfinite(covs))
    if finite:
        sym = 0.5 * (covs + np.transpose(covs, (0, 2, 1)))
        w = np.linalg.eigvalsh(sym)
        # Healthy PSD inverses carry only O(eps)-relative negative
        # eigenvalues from roundoff.
        tol = -1e-12 * np.abs(w).max(axis=-1, keepdims=True)
        if not np.any(w <= tol):
            return covs
    logger.warning(
        "LTM covariances non-PSD from dense inverse; recomputing via "
        "clamped eigen pseudo-inverse of the reduced Hessian"
    )
    if not np.all(np.isfinite(red_h)):
        return None
    lam, vec = np.linalg.eigh(0.5 * (red_h + red_h.T))
    thr = float(min_col_norm) ** 2
    lam_inv = 1.0 / np.maximum(lam, thr)
    cov_full = (vec * lam_inv) @ vec.T
    n_obj = covs.shape[0]
    out = np.empty_like(covs)
    base = n_pose * 6
    for i in range(n_obj):
        blk = cov_full[base + 7 * i : base + 7 * (i + 1),
                       base + 7 * i : base + 7 * (i + 1)]
        out[i] = 0.5 * (blk + blk.T)
    return out


def _extract(pg, config, front_end_data, dtype, caps=None, device="cuda", plain=False):
    max_frame = pg.max_frame_id()
    if max_frame < 0 or not pg.objects:
        return LongTermObjectMap(
            ellipsoids={
                o: (n.semantic_class, n.ellipsoid.copy()) for o, n in pg.objects.items()
            },
            covariances={},
            front_end_data=front_end_data or {},
        )

    scope = _extraction_scope(max_frame, config)
    problem = build_problem(
        pg, scope, config.ltm_solver_residual_params, dtype=dtype, caps=caps, device=device
    )

    # Far-feature filter: zero the weights of their reprojection factors.
    far = far_feature_ids(pg, config.ltm_tunable_params.far_feature_threshold)
    weights = problem.weights
    if far:
        weights = _drop_far_features(pg, problem, weights, far)

    covs, h_diag, ok, red_h = compute_marginal_covariances(
        problem.state, problem.cams, problem.tables, problem.plan, problem.free,
        weights, problem.huber, return_reduced_hessian=True, plain=plain,
    )
    ok = bool(ok)

    min_col_norm = config.ltm_tunable_params.min_col_norm
    state_np = {
        "pose": problem.state.poses.cpu().numpy(),
        "object": problem.state.objects.cpu().numpy(),
    }
    red_h = red_h.cpu().numpy().astype(np.float64)
    deficient = find_rank_deficiencies(red_h, state_np, min_col_norm)

    if (not ok) or deficient:
        # Repair only the identified null-space params with weak scalar
        # priors and retry. No global ridge: it would shrink every reported
        # covariance. If the eigen analysis found nothing and the inverse is
        # still non-finite, extraction failed -> previous-map fallback.
        if not deficient:
            return None
        pp = T.make_param_prior_factors(
            *([d[k] for d in deficient] for k in range(5)), dtype=dtype, device=device
        )
        tables = problem.tables._replace(param_prior=pp)
        covs, h_diag, ok = compute_marginal_covariances(
            problem.state, problem.cams, tables, problem.plan, problem.free,
            weights, problem.huber, plain=plain,
        )
        if not bool(ok):
            return None

    covs = _ensure_psd_covs(
        covs.cpu().numpy(), red_h, state_np["pose"].shape[0], min_col_norm
    )
    if covs is None:
        return None
    ellipsoids = {}
    covariances = {}
    obj_row_of = {int(o): i for i, o in enumerate(problem.obj_rows)}
    for obj_id, node in pg.objects.items():
        ellipsoids[obj_id] = (node.semantic_class, node.ellipsoid.copy())
        if obj_id in obj_row_of:
            covariances[obj_id] = covs[obj_row_of[obj_id]]
        else:
            # Object had no factors in the extraction problem (shouldn't
            # happen with force-include, but stay safe).
            covariances[obj_id] = np.eye(7)
    return LongTermObjectMap(
        ellipsoids=ellipsoids,
        covariances=covariances,
        front_end_data=front_end_data or {},
    )


def _drop_far_features(pg, problem, weights, far):
    """Zero the weights of the reprojection factors of ``far`` features."""
    rp_w = weights.reproj.cpu().numpy().copy()
    for i, fid in enumerate(problem.reproj_rows):
        if pg.visual_factors[fid].feature_id in far:
            rp_w[i] = 0.0
    return weights._replace(reproj=torch.from_numpy(rp_w).to(weights.reproj.device))


def seed_pose_graph_from_ltm(pg: PoseGraph, ltm: LongTermObjectMap):
    """Pre-insert LTM ellipsoids with known ids + one unary prior factor each."""
    for obj_id, (semantic_class, ellipsoid) in ltm.ellipsoids.items():
        pg.add_ltm_object(obj_id, ellipsoid, semantic_class)
        cov = ltm.covariances.get(obj_id)
        if cov is not None:
            pg.add_ltm_factor(obj_id, ellipsoid, cov)
