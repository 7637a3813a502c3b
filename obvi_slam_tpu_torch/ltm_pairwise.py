"""Pairwise-covariance long-term object map (alternative LTM variant).

Counterpart of ``obvi_slam_tpu/ltm_pairwise.py`` (the reference's
``PairwiseCovarianceLongTermObjectMap``): instead of independent per-object 7x7 marginals, stores the joint object-pair
covariance blocks Sigma_{ij} (7x7 cross blocks of the full inverse reduced
Hessian), preserving inter-object correlation for the next session.

Parity note: the reference ships this variant but its default pipeline uses
the independent-ellipsoids map everywhere (offline_object_visual_slam_main
instantiates IndependentEllipsoidsLongTermObjectMap); factor creation from the
pairwise map is likewise secondary. Here, extraction/serialization are full,
and ``to_independent()`` bridges into the default prior-factor path (dropping
cross-correlations exactly as the independent map does).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch.ltm import LongTermObjectMap, _drop_far_features, far_feature_ids
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.solver.problem import Scope, build_problem
from obvi_slam_tpu_torch.solver.schur import compute_marginal_covariances


@dataclass
class PairwiseCovarianceLongTermObjectMap:
    ellipsoids: Dict[int, tuple] = field(default_factory=dict)
    # (obj_i, obj_j) i <= j -> 7x7 covariance block (diag blocks are marginals)
    pairwise_covariances: Dict[Tuple[int, int], np.ndarray] = field(
        default_factory=dict
    )
    front_end_data: Dict[int, dict] = field(default_factory=dict)

    def to_json(self):
        return {
            "ellipsoids": {
                str(k): [cls, np.asarray(e).tolist()]
                for k, (cls, e) in self.ellipsoids.items()
            },
            "pairwise_covariances": {
                f"{i},{j}": np.asarray(c).tolist()
                for (i, j), c in self.pairwise_covariances.items()
            },
            "front_end_data": {str(k): v for k, v in self.front_end_data.items()},
        }

    @classmethod
    def from_json(cls, d):
        pc = {}
        for key, v in d["pairwise_covariances"].items():
            i, j = key.split(",")
            pc[(int(i), int(j))] = np.array(v)
        return cls(
            ellipsoids={
                int(k): (v[0], np.array(v[1])) for k, v in d["ellipsoids"].items()
            },
            pairwise_covariances=pc,
            front_end_data={int(k): v for k, v in d["front_end_data"].items()},
        )

    def save(self, path):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_independent(self) -> LongTermObjectMap:
        """Bridge to the default prior path: keep the diagonal blocks."""
        return LongTermObjectMap(
            ellipsoids=dict(self.ellipsoids),
            covariances={
                i: self.pairwise_covariances[(i, i)]
                for i in self.ellipsoids
                if (i, i) in self.pairwise_covariances
            },
            front_end_data=dict(self.front_end_data),
        )


def extract_pairwise_covariance_ltm(
    pg: PoseGraph,
    config: cfg.FullOVSLAMConfig,
    front_end_data: Optional[Dict[int, dict]] = None,
    dtype=np.float64,
    device="cuda",
    plain: bool = False,
) -> Optional[PairwiseCovarianceLongTermObjectMap]:
    """Same extraction problem as the independent map (far-feature filter,
    no shape priors, LTM forced), but the full object-block inverse is kept
    (the reduced system comes from ``device``; its inverse is host numpy)."""
    max_frame = pg.max_frame_id()
    if max_frame < 0 or not pg.objects:
        return PairwiseCovarianceLongTermObjectMap(
            ellipsoids={
                o: (n.semantic_class, n.ellipsoid.copy()) for o, n in pg.objects.items()
            },
            front_end_data=front_end_data or {},
        )
    en = config.optimization_factors_enabled_params
    scope = Scope(
        min_frame_id=0,
        max_frame_id=max_frame,
        poses_prior_to_window_to_keep_constant=en.poses_prior_to_window_to_keep_constant,
        min_object_observations=en.min_object_observations,
        min_low_level_feature_observations=en.min_low_level_feature_observations,
        min_low_level_feature_observations_per_frame=en.min_low_level_feature_observations_per_frame,
        force_include_ltm_objs=True,
        include_shape_priors=False,
    )
    problem = build_problem(
        pg, scope, config.ltm_solver_residual_params, dtype=dtype, device=device
    )

    weights = problem.weights
    far = far_feature_ids(pg, config.ltm_tunable_params.far_feature_threshold)
    if far:
        weights = _drop_far_features(pg, problem, weights, far)

    _, h_diag, ok, a = compute_marginal_covariances(
        problem.state, problem.cams, problem.tables, problem.plan, problem.free,
        weights, problem.huber, return_reduced_hessian=True,
        ridge=config.ltm_tunable_params.min_col_norm, plain=plain,
    )
    a = a.cpu().numpy()
    try:
        sigma = np.linalg.inv(a)
    except np.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(sigma)):
        return None

    n_pose = problem.state.poses.shape[0]
    obj_row_of = {int(o): i for i, o in enumerate(problem.obj_rows)}
    off = n_pose * 6

    def block(i, j):
        return sigma[off + 7 * i : off + 7 * (i + 1), off + 7 * j : off + 7 * (j + 1)]

    pairwise = {}
    obj_ids = sorted(pg.objects)
    for ii, oi in enumerate(obj_ids):
        if oi not in obj_row_of:
            continue
        ri = obj_row_of[oi]
        for oj in obj_ids[ii:]:
            if oj not in obj_row_of:
                continue
            rj = obj_row_of[oj]
            pairwise[(oi, oj)] = block(ri, rj)
    return PairwiseCovarianceLongTermObjectMap(
        ellipsoids={
            o: (n.semantic_class, n.ellipsoid.copy()) for o, n in pg.objects.items()
        },
        pairwise_covariances=pairwise,
        front_end_data=front_end_data or {},
    )
