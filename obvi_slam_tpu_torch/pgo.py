"""Pose-graph + objects optimization for global-BA frames.

Counterpart of ``obvi_slam_tpu/pgo.py`` (the reference's
``runPgoPlusEllipsoids`` and its pre-PGO tracking solve):

  1. tracking: short local BA over the last few poses (scope min =
     frame - poses_prior_to_window_to_keep_constant)
  2. PGO: synthesize a relative-pose factor between every consecutive pose
     pair from the current estimates, covariance from the PGO odometry
     model; optimize poses + objects with visual factors off
  3. re-anchor every feature analytically to its first-observation frame
     (enable_visual_non_opt_feature_adjustment_post_pgo)
  4. feature-only BA with poses and objects fixed
     (enable_visual_feats_only_opt_post_pgo)

Each solve is one LM solve of the runner (``runner.solve``) on its device;
the window problems come from the runner's caps pools "pgo_tracking", "pgo"
and "pgo_vf".
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch.frontend.visual_features import _pose_to_rt
from obvi_slam_tpu_torch.solver.problem import write_back
from obvi_slam_tpu_torch.timing import timer


def run_tracking_solve(runner, data, pg, next_frame_id):
    """Pre-PGO tracking solve: a BA over the newest pose and the
    ``poses_prior_to_window_to_keep_constant`` poses before it (held)."""
    from obvi_slam_tpu_torch.runner import lm_params_from_config

    en = runner.config.optimization_factors_enabled_params
    min_frame = max(0, next_frame_id - en.poses_prior_to_window_to_keep_constant)
    scope = runner._scope(min_frame, next_frame_id)
    with timer("obj_only_pgo_local_track_build"):
        problem = runner._build_problem(pg, scope, "pgo_tracking")
    with timer("obj_only_pgo_local_track_solve"):
        state, summary = runner.solve(
            problem,
            lm_params_from_config(runner.config.pgo_solver_params.pre_pgo_tracking_solver_params),
        )
    write_back(pg, problem, state)
    return summary


def run_pgo_plus_ellipsoids(runner, data, pg, max_frame_id, final_run, attempt_num=0):
    """Steps 2-4 over frames [0, max_frame_id]; the PGO solve is logged as
    phase 0. Returns False when a pose of the chain is missing."""
    from obvi_slam_tpu_torch.runner import generate_odom_cov, lm_params_from_config

    pgo_params = runner.config.pgo_solver_params

    # 1. Synthesize consecutive relative-pose factors from current estimates.
    with timer("obj_only_pgo_build_pgo"):
        synthesized: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        for frame in range(1, max_frame_id + 1):
            before = pg.get_robot_pose(frame - 1)
            after = pg.get_robot_pose(frame)
            if before is None or after is None:
                return False
            rb, tb = _pose_to_rt(before)
            ra, ta = _pose_to_rt(after)
            rel = np.concatenate(
                [rb.T @ (ta - tb), Rotation.from_matrix(rb.T @ ra).as_rotvec()]
            )
            cov = generate_odom_cov(rel, pgo_params.relative_pose_cov_params)
            synthesized.append((frame - 1, frame, rel, cov))

        # Feature positions relative to their first-observation frame.
        rel_positions_from_first = {}
        if pgo_params.enable_visual_non_opt_feature_adjustment_post_pgo:
            for feat_id, pos in pg.features.items():
                first = pg.first_frame_for_feature.get(feat_id)
                if first is None:
                    continue
                pose = pg.get_robot_pose(first)
                if pose is None:
                    continue
                r, t = _pose_to_rt(pose)
                rel_positions_from_first[feat_id] = (first, r.T @ (pos - t))

        scope = dataclasses.replace(
            runner._scope(0, max_frame_id),
            include_visual_factors=False,
            poses_prior_to_window_to_keep_constant=1,
        )
        problem = runner._build_problem(
            pg, scope, "pgo",
            synthesized_relpose=synthesized,
            relpose_huber_override=pgo_params.relative_pose_factor_huber_loss,
        )

    with timer("obj_only_pgo_solve_pgo"):
        solver_params = (
            pgo_params.final_pgo_optimization_solver_params
            if final_run
            else pgo_params.pgo_optimization_solver_params
        )
        state, summary = runner.solve(problem, lm_params_from_config(solver_params))
    write_back(pg, problem, state)
    runner._log_solve(problem, summary, max_frame_id, True, 0, attempt_num)

    # 3. Analytic feature re-anchoring.
    if pgo_params.enable_visual_non_opt_feature_adjustment_post_pgo:
        with timer("obj_only_pgo_manual_feat_adjust"):
            for feat_id, (first, rel) in rel_positions_from_first.items():
                pose = pg.get_robot_pose(first)
                if pose is None:
                    continue
                r, t = _pose_to_rt(pose)
                pg.features[feat_id] = r @ rel + t

    # 4. Feature-only BA with poses and objects fixed.
    if pgo_params.enable_visual_feats_only_opt_post_pgo:
        vf_scope = dataclasses.replace(
            runner._scope(0, max_frame_id),
            fix_poses=True,
            fix_objects=True,
            include_object_factors=False,
        )
        with timer("obj_only_pgo_opt_feat_adjust_build"):
            vf_problem = runner._build_problem(pg, vf_scope, "pgo_vf")
        with timer("obj_only_pgo_opt_feat_adjust_solve"):
            vf_params = (
                pgo_params.final_post_pgo_vf_adjustment_solver_params
                if final_run
                else pgo_params.post_pgo_vf_adjustment_solver_params
            )
            vf_state, _ = runner.solve(vf_problem, lm_params_from_config(vf_params))
        write_back(pg, vf_problem, vf_state)
    return True
