"""Offline problem runner: the per-frame optimization loop of an
object-visual session.

Counterpart of ``obvi_slam_tpu/runner.py`` (``OfflineProblemRunner``):

  for frame 1..N:
      window = provide_optimization_window(frame)
      add frame data (pose-chain init, odometry factor, visual frontend,
                      bounding-box frontend hook)
      run_optimization_iteration(window, frame):
          [global-BA frames with PGO enabled: tracking solve + PGO with the
           objects + feature re-anchoring + feature-only BA (pgo.py)]
          build the window problem (solver.problem, session caps pool)
          two-phase BA: phase-1 LM, outlier ranking + factor re-selection,
          phase-2 LM from the window's input values (one solve_two_phase
          call), or one LM solve when feature_outlier_percentage is 0
          jump check -> revert
  final: run_optimization_iteration(0, N)
  merge loop: while the object_merger hook merges -> full re-optimization

The pose graph stays on the host; each window's tables go to ``device``.
Timer names are the reference's (``timing.timer``). Not ported, each raising
``NotImplementedError``: the host-loop two-phase branch
(``use_fused_solver=False``) and the multi-device ``mesh`` /
``shard_local_ba``. The reference's capacity presizing, device diff-sync and
optimization logger are not ported either.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch.frontend.visual_features import VisualFeatureFrontend, _pose_to_rt
from obvi_slam_tpu_torch.offline_data import OfflineProblemData
from obvi_slam_tpu_torch.pgo import run_pgo_plus_ellipsoids, run_tracking_solve
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.solver import LMParams, TwoPhaseConfig, solve, solve_two_phase
from obvi_slam_tpu_torch.solver.problem import (
    Problem,
    Scope,
    build_problem,
    update_caps_pool,
    write_back,
)
from obvi_slam_tpu_torch.timing import timer

logger = logging.getLogger(__name__)


def provide_optimization_window(max_frame_to_opt, max_frame_id, sliding_window_params):
    """First frame of the window that ends at ``max_frame_to_opt``; 0 (the
    whole trajectory, a global BA) at the last frame, at multiples of the
    global-BA frequency and while the trajectory is shorter than a window."""
    if max_frame_to_opt == max_frame_id:
        return 0
    if max_frame_to_opt % sliding_window_params.global_ba_frequency == 0:
        return 0
    if max_frame_to_opt < sliding_window_params.local_ba_window_size:
        return 0
    return max_frame_to_opt - sliding_window_params.local_ba_window_size


def generate_odom_cov(rel_pose: np.ndarray, cov_params) -> np.ndarray:
    """Odometry covariance from the relative pose [t, rotvec]."""
    k_min_std = 1e-3
    transl = rel_pose[:3]
    rot = rel_pose[3:6]
    angle = np.linalg.norm(rot)
    std = np.zeros(6)
    std[:3] = (
        np.abs(transl) * cov_params.transl_error_mult_for_transl_error
        + abs(angle) * cov_params.rot_error_mult_for_transl_error
    )
    std[3:] = (
        np.abs(rot) * cov_params.rot_error_mult_for_rot_error
        + np.linalg.norm(transl) * cov_params.transl_error_mult_for_rot_error
    )
    return np.diag(np.maximum(std, k_min_std) ** 2)


def lm_params_from_config(p: cfg.OptimizationSolverParams) -> LMParams:
    return LMParams(
        max_num_iterations=p.max_num_iterations,
        allow_non_monotonic_steps=p.allow_non_monotonic_steps,
        function_tolerance=p.function_tolerance,
        gradient_tolerance=p.gradient_tolerance,
        parameter_tolerance=p.parameter_tolerance,
        initial_trust_region_radius=p.initial_trust_region_radius,
        max_trust_region_radius=p.max_trust_region_radius,
    )


@dataclass
class RunnerHooks:
    """Optional injection points."""

    # Called as (pg, frame_id) after each frame's data adding.
    frame_data_extra: Optional[Callable] = None
    # Bounding-box frontend: called as (data, pg, frame_id). None = visual-only.
    bb_frontend: Optional[Callable] = None
    # Visualization callback: (pg, stage, frame_id).
    visualization: Optional[Callable] = None
    # Object merge decider at session end: (pg) -> bool (True if merged any).
    object_merger: Optional[Callable] = None
    # Called with (frame_id, summary, phase) after each solve.
    solve_logger: Optional[Callable] = None
    # Checkpoint emitter, called as (pg, label) with the labels
    # "pose_graph_state_checkpoint_pre_optimization_<N>_attempt_<k>" (before
    # every final optimization attempt), "..._post_frame_add" (after the
    # final optimization) and "..._post_postprocessing" (after the merge loop).
    checkpoint: Optional[Callable] = None


@dataclass
class OptLogRecord:
    """One row of the per-solve log."""

    frame_id: int
    global_ba: bool
    phase: int
    attempt: int
    num_poses: int
    num_features: int
    num_objects: int
    initial_cost: float
    final_cost: float
    iterations: int
    termination: str


class OfflineProblemRunner:
    """Runs a session's per-frame optimizations on ``device``.

    ``dtype`` is the numpy float type of the window tables; ``plain`` runs
    every kernel's plain PyTorch version (reference runs)."""

    def __init__(
        self,
        config: cfg.FullOVSLAMConfig,
        hooks: RunnerHooks = None,
        dtype=np.float64,
        device="cuda",
        plain: bool = False,
        mesh=None,
        shard_local_ba: bool = False,
        use_fused_solver: Optional[bool] = None,
    ):
        if mesh is not None or shard_local_ba:
            raise NotImplementedError("the multi-device runner (mesh) is not ported")
        if use_fused_solver is False:
            raise NotImplementedError("the host-loop two-phase branch is not ported")
        self.config = config
        self.hooks = hooks or RunnerHooks()
        self.dtype = dtype
        self.device = device
        self.plain = plain
        self.opt_log: List[OptLogRecord] = []
        self.visual_frontend = None  # set by run_optimization
        # Session high-water capacity pools, one per solve class ("local",
        # "global"), passed as ``caps`` to build_problem.
        self._caps_pools = {}

    def caps_pool(self, key: str) -> dict:
        return self._caps_pools.setdefault(key, {})

    def _build_problem(self, pg, scope, key: str, **build_kw) -> Problem:
        """build_problem at the session pool's capacities; grows the pool.
        ``build_kw``: PGO's synthesized relpose chain and Huber delta."""
        pool = self.caps_pool(key)
        problem = build_problem(
            pg, scope, self.config.object_visual_pose_graph_residual_params,
            dtype=self.dtype, caps=pool, device=self.device, **build_kw,
        )
        update_caps_pool(pool, problem)
        return problem

    def solve(self, problem: Problem, params: LMParams, weights=None):
        """One LM solve of a built Problem: (final_state, LMSummary)."""
        return solve(
            problem.state, problem.cams, problem.tables, problem.plan, problem.free,
            problem.weights if weights is None else weights, params, problem.huber,
            plain=self.plain,
        )

    # ------------------------------------------------------------------
    def _gba_checker(self, frame_id, max_frame_id) -> bool:
        return (
            provide_optimization_window(frame_id, max_frame_id, self.config.sliding_window_params)
            == 0
        )

    def _iteration_params(self, frame_id, max_frame_id) -> cfg.OptimizationIterationParams:
        """Final, global or local iteration parameters."""
        if frame_id == max_frame_id:
            return self.config.final_ba_iteration_params
        if self._gba_checker(frame_id, max_frame_id):
            return self.config.global_ba_iteration_params
        return self.config.local_ba_iteration_params

    def _scope(self, min_frame, max_frame) -> Scope:
        en = self.config.optimization_factors_enabled_params
        return Scope(
            min_frame_id=min_frame,
            max_frame_id=max_frame,
            include_object_factors=en.include_object_factors,
            include_visual_factors=en.include_visual_factors,
            fix_poses=en.fix_poses,
            fix_objects=en.fix_objects,
            fix_visual_features=en.fix_visual_features,
            fix_ltm_objects=en.fix_ltm_objects,
            poses_prior_to_window_to_keep_constant=en.poses_prior_to_window_to_keep_constant,
            min_object_observations=en.min_object_observations,
            min_low_level_feature_observations=en.min_low_level_feature_observations,
            min_low_level_feature_observations_per_frame=(
                en.min_low_level_feature_observations_per_frame
            ),
        )

    # ------------------------------------------------------------------
    def add_frame_data(
        self, data: OfflineProblemData, pg: PoseGraph, min_frame_id, frame_to_add
    ):
        """Adds a frame: its pose (the initial estimate's delta from the
        previous frame chained onto the optimized previous pose), the
        odometry factor, then the frontends' observations."""
        init_pose = data.get_robot_pose_estimate(frame_to_add)
        if init_pose is None:
            raise ValueError(f"no initial pose estimate for frame {frame_to_add}")

        if frame_to_add == 0:
            pg.add_frame(0, init_pose)
        else:
            prev_init = data.get_robot_pose_estimate(frame_to_add - 1)
            prev_optim = pg.get_robot_pose(frame_to_add - 1)
            if prev_init is None or prev_optim is None:
                pg.add_frame(frame_to_add, init_pose)
            else:
                r_pi, t_pi = _pose_to_rt(prev_init)
                r_ci, t_ci = _pose_to_rt(init_pose)
                rel_r = r_pi.T @ r_ci
                rel_t = r_pi.T @ (t_ci - t_pi)
                r_po, t_po = _pose_to_rt(prev_optim)
                pg.add_frame(
                    frame_to_add,
                    np.concatenate(
                        [r_po @ rel_t + t_po, Rotation.from_matrix(r_po @ rel_r).as_rotvec()]
                    ),
                )
            # Odometry factor from the consecutive initial-pose delta.
            if prev_init is not None:
                r_pi, t_pi = _pose_to_rt(prev_init)
                r_ci, t_ci = _pose_to_rt(init_pose)
                rel = np.concatenate(
                    [r_pi.T @ (t_ci - t_pi), Rotation.from_matrix(r_pi.T @ r_ci).as_rotvec()]
                )
                cov = generate_odom_cov(
                    rel,
                    self.config.object_visual_pose_graph_residual_params.relative_pose_cov_params,
                )
                pg.add_pose_factor(frame_to_add - 1, frame_to_add, rel, cov)

        if self.visual_frontend is not None:
            self.visual_frontend.add_visual_feature_observations(
                data, pg, min_frame_id, frame_to_add
            )
        if self.hooks.bb_frontend is not None:
            self.hooks.bb_frontend(data, pg, frame_to_add)
        if self.hooks.frame_data_extra is not None:
            self.hooks.frame_data_extra(pg, frame_to_add)

    # ------------------------------------------------------------------
    def run_optimization_iteration(
        self,
        data: OfflineProblemData,
        pg: PoseGraph,
        start_opt_with_frame: int,
        next_frame_id: int,
        max_frame_id: int,
        attempt_num: int = 0,
    ) -> bool:
        iteration_params = self._iteration_params(next_frame_id, max_frame_id)
        global_ba = self._gba_checker(next_frame_id, max_frame_id)
        en = self.config.optimization_factors_enabled_params
        # PGO on global-BA frames; it may replace the visual-feature BA.
        run_visual_feature_opt = True
        if global_ba:
            final_attempt = next_frame_id == max_frame_id and attempt_num > 0
            run_pgo = (
                en.use_pose_graph_on_final_global_ba if final_attempt
                else en.use_pose_graph_on_global_ba
            )
            if run_pgo:
                run_visual_feature_opt = (
                    en.use_visual_features_on_final_global_ba if final_attempt
                    else en.use_visual_features_on_global_ba
                )
                with timer("obj_only_pgo_full_process"):
                    run_tracking_solve(self, data, pg, next_frame_id)
                    run_pgo_plus_ellipsoids(
                        self, data, pg, next_frame_id, next_frame_id == max_frame_id,
                        attempt_num,
                    )
        if not run_visual_feature_opt:
            return True

        scope = self._scope(start_opt_with_frame, next_frame_id)
        two_phase = iteration_params.feature_outlier_percentage > 0
        tag = "gba" if global_ba else "lba"
        key = "global" if global_ba else "local"

        with timer("global_bundle_adjustment" if global_ba else "local_bundle_adjustment"):
            with timer(f"phase_one_{tag}_build_opt"):
                problem = self._build_problem(pg, scope, key)
            snapshot = pg.snapshot_values()
            if two_phase:
                # Both phases in one call; the timer covers both.
                with timer(f"phase_one_{tag}_solve_opt"):
                    state, s1, s2 = self._solve_two_phase(problem, iteration_params)
                self._log_solve(problem, s1, next_frame_id, global_ba, 1, attempt_num)
                self._log_solve(problem, s2, next_frame_id, global_ba, 2, attempt_num)
            else:
                with timer(f"phase_one_{tag}_solve_opt"):
                    state, summary = self.solve(
                        problem, lm_params_from_config(iteration_params.phase_one_opt_params)
                    )
                self._log_solve(problem, summary, next_frame_id, global_ba, 1, attempt_num)
            write_back(pg, problem, state)

            # Jump detection -> full revert.
            if iteration_params.allow_reversion_after_detecting_jumps:
                if not self._consecutive_poses_stable(
                    pg,
                    scope.min_frame_id,
                    scope.max_frame_id,
                    iteration_params.consecutive_pose_transl_tol,
                    iteration_params.consecutive_pose_orient_tol,
                ):
                    logger.warning(
                        "Jump detected after optimizing frame %d; reverting", next_frame_id
                    )
                    pg.restore_values(snapshot)

        if self.hooks.visualization is not None:
            self.hooks.visualization(pg, "AFTER_EACH_OPTIMIZATION", next_frame_id)
        return True

    def _solve_two_phase(self, problem: Problem, iteration_params):
        """Phase 1, re-selection and phase 2 of one window iteration."""
        sc = problem.scope
        tp_cfg = TwoPhaseConfig(
            feature_outlier_percentage=float(iteration_params.feature_outlier_percentage),
            min_low_level_feature_observations=int(sc.min_low_level_feature_observations),
            min_low_level_feature_observations_per_frame=int(
                sc.min_low_level_feature_observations_per_frame
            ),
            min_object_observations=int(sc.min_object_observations),
            include_visual_factors=bool(sc.include_visual_factors),
            include_object_factors=bool(sc.include_object_factors),
            include_shape_priors=bool(sc.include_shape_priors),
            fix_objects=bool(sc.fix_objects),
            fix_ltm_objects=bool(sc.fix_ltm_objects),
            force_include_ltm_objs=bool(sc.force_include_ltm_objs),
        )
        return solve_two_phase(
            problem.state, problem.cams, problem.tables, problem.plan, problem.free,
            problem.weights, problem.aux,
            lm_params_from_config(iteration_params.phase_one_opt_params),
            lm_params_from_config(iteration_params.phase_two_opt_params),
            problem.huber, tp_cfg, plain=self.plain,
        )

    def _consecutive_poses_stable(self, pg, min_frame, max_frame, transl_tol, orient_tol):
        """False when two consecutive poses of the window lie further apart
        than the translation or orientation tolerance."""
        for frame in range(min_frame + 1, max_frame + 1):
            prev = pg.get_robot_pose(frame - 1)
            curr = pg.get_robot_pose(frame)
            if prev is None or curr is None:
                continue
            rp, tp = _pose_to_rt(prev)
            rc, tc = _pose_to_rt(curr)
            rel_t = rp.T @ (tc - tp)
            cos_a = np.clip((np.trace(rp.T @ rc) - 1) / 2, -1, 1)
            if np.linalg.norm(rel_t) > transl_tol or abs(np.arccos(cos_a)) > orient_tol:
                return False
        return True

    def _log_solve(self, problem, summary, frame_id, global_ba, phase, attempt):
        self.opt_log.append(OptLogRecord(
            frame_id=frame_id,
            global_ba=global_ba,
            phase=phase,
            attempt=attempt,
            num_poses=len(problem.pose_rows),
            num_features=len(problem.point_rows),
            num_objects=len(problem.obj_rows),
            initial_cost=summary.initial_cost,
            final_cost=summary.final_cost,
            iterations=summary.num_iterations,
            termination=summary.termination,
        ))
        if self.hooks.solve_logger is not None:
            self.hooks.solve_logger(frame_id, summary, phase)

    # ------------------------------------------------------------------
    def run_optimization(
        self,
        data: OfflineProblemData,
        pg: PoseGraph,
        visual_frontend=None,
        start_at_frame: int = 0,
        add_data_for_starting_frame: bool = True,
        max_frame_id: Optional[int] = None,
    ) -> bool:
        """The session: per-frame data adding and optimization, the final
        optimization over the whole trajectory, then the merge loop."""
        self.visual_frontend = visual_frontend
        if max_frame_id is None:
            max_frame_id = data.max_frame_id()
        lt = self.config.limit_traj_eval_params
        if lt.should_limit_trajectory_evaluation:
            max_frame_id = min(lt.max_frame_id, max_frame_id)

        with timer("offline_runner_online_portion"):
            if start_at_frame == 0 and add_data_for_starting_frame:
                self.add_frame_data(data, pg, 0, 0)
            for next_frame_id in range(max(1, start_at_frame), max_frame_id + 1):
                with timer("optimization_iteration"):
                    window_start = provide_optimization_window(
                        next_frame_id, max_frame_id, self.config.sliding_window_params
                    )
                    if next_frame_id != start_at_frame or add_data_for_starting_frame:
                        with timer("frame_data_adder"):
                            self.add_frame_data(data, pg, window_start, next_frame_id)
                    if not self.run_optimization_iteration(
                        data, pg, window_start, next_frame_id, max_frame_id
                    ):
                        return False

        with timer("offline_runner_offline_portion"):
            # Final refinement over the whole trajectory.
            self._checkpoint(
                pg, f"pose_graph_state_checkpoint_pre_optimization_{max_frame_id}_attempt_1"
            )
            if not self.run_optimization_iteration(
                data, pg, 0, max_frame_id, max_frame_id, attempt_num=1
            ):
                return False
            self._checkpoint(pg, "pose_graph_state_checkpoint_post_frame_add")

            if self.hooks.object_merger is not None:
                with timer("post_session_map_merge"):
                    post_round = 2
                    while self.hooks.object_merger(pg):
                        self._checkpoint(
                            pg,
                            "pose_graph_state_checkpoint_pre_optimization_"
                            f"{max_frame_id}_attempt_{post_round}",
                        )
                        if not self.run_optimization_iteration(
                            data, pg, 0, max_frame_id, max_frame_id, attempt_num=post_round
                        ):
                            return False
                        post_round += 1
            self._checkpoint(pg, "pose_graph_state_checkpoint_post_postprocessing")
        return True

    def _checkpoint(self, pg, label: str):
        if self.hooks.checkpoint is not None:
            self.hooks.checkpoint(pg, label)


def visual_frontend_for(runner: OfflineProblemRunner, data: OfflineProblemData):
    """A VisualFeatureFrontend with the runner config's visual-feature
    parameters and its global-BA schedule over ``data``'s frames."""
    vp = runner.config.visual_feature_params
    max_frame_id = data.max_frame_id()
    return VisualFeatureFrontend(
        gba_checker=lambda f: runner._gba_checker(f, max_frame_id),
        reprojection_error_provider=lambda *a: vp.reprojection_error_std_dev,
        min_parallax_pixel=vp.min_visual_feature_parallax_pixel_requirement,
        inlier_epipolar_err_thresh=vp.inlier_epipolar_err_thresh,
        check_past_n_frames=vp.check_past_n_frames_for_epipolar_err,
    )
