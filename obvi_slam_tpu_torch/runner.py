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
          phase-2 LM from the window's input values (one fused solve of
          CUDA graphs on the card, one solve_two_phase call of host LM
          loops, or the reference's host loop: see
          ``OfflineProblemRunner``), or one LM solve when
          feature_outlier_percentage is 0
          jump check -> revert
  final: run_optimization_iteration(0, N)
  merge loop: while the object_merger hook merges -> full re-optimization

The pose graph stays on the host; each window's tables go to ``device``.
Timer names are the reference's (``timing.timer``); the port's spans nest
inside them and carry the frame id, which ``add_frame_data`` and
``run_optimization_iteration`` set (``timing.set_frame``). Every solve's LM
iterations go to the optimization logger (``optlog``) when it has a
directory. Before frame 0 ``presize_session_caps`` seeds every caps pool
from the raw data's counts, as the reference does, and from the objects
seeded from a long-term map, which the reference does not, so that the
windows, global BAs and PGO problems keep the session's capacities from
the first frame and the card's CUDA graphs (cached by shape) see few
shapes. The reference's device diff-sync is not ported.

With a ``mesh`` (``parallel.make_mesh``) every rank runs the session
identically on the host, and global-BA problems (window problems too with
``shard_local_ba``) are sharded on the factor axis (``shard_problem``) and
solved on the ranks together; the other solves (windows, PGO) run whole on
every rank. Each solve's state is broadcast from rank 0, so the ranks' pose
graphs stay equal bit for bit. Rank 0 alone calls the checkpoint and solve
hooks and feeds the optimization logger.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import optlog
from obvi_slam_tpu_torch.frontend.visual_features import VisualFeatureFrontend, _pose_to_rt
from obvi_slam_tpu_torch.offline_data import OfflineProblemData
from obvi_slam_tpu_torch.parallel import comm, sharding
from obvi_slam_tpu_torch.pgo import run_pgo_plus_ellipsoids, run_tracking_solve
from obvi_slam_tpu_torch.pose_graph import (
    OBJECT_OBSERVATION_FACTOR,
    REPROJECTION_FACTOR,
    PoseGraph,
)
from obvi_slam_tpu_torch.solver import (
    LMParams,
    TwoPhaseConfig,
    solve,
    solve_fused,
    solve_two_phase,
    solve_two_phase_fused,
)
from obvi_slam_tpu_torch.solver.plan import BAND_TP, _round_up
from obvi_slam_tpu_torch.solver.problem import (
    Problem,
    Scope,
    _bucket,
    build_problem,
    reweight_for_exclusions,
    update_caps_pool,
    write_back,
)
from obvi_slam_tpu_torch.timing import HOST_WAIT, set_frame, timer

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


def log_iterations(opt_type: str, opt_id, summary, problem: Problem):
    """A solve's LM iterations to the optimization logger, when it has a
    directory, with the problem's free parameters (the reference's
    num_parameters_reduced: 6 per free pose, 3 per point, 7 per object)."""
    ilf = optlog.IterationLoggerFactory.instance()
    if ilf.enabled:
        f = problem.free
        n_free = 6 * f.poses.sum() + 3 * f.points.sum() + 7 * f.objects.sum()
        with timer(HOST_WAIT):
            n_free = int(n_free)
        ilf.log_iterations(opt_type, str(opt_id), summary, n_free)


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
    every kernel's plain PyTorch version (reference runs).

    ``use_fused_solver``: True runs every solve fused (``solve_fused``; a
    two-phase window as one ``solve_two_phase_fused`` call, outlier ranking
    and re-selection on the device): CUDA graphs replayed on the card, the
    same masked iteration eagerly on the CPU. None, as the reference, takes
    the fused solves on CUDA and the host LM loop (``solve``; a two-phase
    window as one ``solve_two_phase`` call, re-selection on the device) on
    the CPU. False runs the host LM loop and the reference's host loop of a
    two-phase window (phase-1 solve, outlier ranking on the host,
    ``reweight_for_exclusions``, phase-2 solve, each phase under its own
    timers). All select the same exclusions. With a ``mesh`` every solve
    takes the host LM loop: the collectives are not captured.

    ``mesh``: shard global-BA solves over its ranks (a ``parallel.Mesh`` of
    an initialized process group; see the module docstring);
    ``shard_local_ba`` shards the window solves as well."""

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
        if mesh is not None:
            sharding.check_mesh(mesh)
        self.mesh = mesh
        self.shard_local_ba = shard_local_ba
        self.is_rank0 = mesh is None or mesh.rank == 0
        self.config = config
        self.hooks = hooks or RunnerHooks()
        self.dtype = dtype
        self.device = device
        self.plain = plain
        self.use_fused_solver = use_fused_solver
        self.opt_log: List[OptLogRecord] = []
        self.visual_frontend = None  # set by run_optimization
        # Session high-water capacity pools, one per solve class ("local",
        # "global", "pgo", "pgo_vf", "pgo_tracking"), passed as ``caps`` to
        # build_problem; seeded by presize_session_caps.
        self._caps_pools = {}

    def caps_pool(self, key: str) -> dict:
        return self._caps_pools.setdefault(key, {})

    def _window_caps_seed(
        self, data: OfflineProblemData, lo: int, hi: int, n_ltm: int = 0
    ) -> Dict[str, int]:
        """Upper bound of the caps of any problem over frames [lo, hi], from
        the raw counts: the frontends admit only observations present in
        the raw data, and objects by the raw bounding boxes, besides the
        ``n_ltm`` objects seeded from a long-term map (each with its LTM
        prior and shape prior). An under-estimate is safe: caps are minimums
        and a larger window grows its pool."""
        obs = pairs = cross = feats = 0
        max_frames_per_track = 0
        tile_counts: Dict[int, int] = {}
        band_ok = True
        for track in data.feature_tracks.values():
            frames_in = [f for f in track if lo <= f <= hi]
            if not frames_in:
                continue
            feats += 1
            nf = len(frames_in)
            pairs += nf
            cross += nf * nf
            max_frames_per_track = max(max_frames_per_track, nf)
            obs += sum(len(track[f]) for f in frames_in)
            # Home band group of the track (pose row = frame - lo in a
            # global window; local windows never reach the band layout).
            fr0, fr1 = min(frames_in) - lo, max(frames_in) - lo
            home = fr0 // BAND_TP
            tile_counts[home] = tile_counts.get(home, 0) + 1
            if fr1 - home * BAND_TP >= 2 * BAND_TP:
                band_ok = False

        bbs = sum(
            sum(len(v) for v in by_cam.values())
            for f, by_cam in data.bounding_boxes.items() if lo <= f <= hi
        )
        n_frames = hi - lo + 1
        pose_cap = _bucket(n_frames + 1, minimum=8)
        seed = {
            "reproj": _bucket(max(obs, 1)),
            "bbox": _bucket(max(bbs, 1)),
            "shape": _bucket(16),
            "ltm": _bucket(n_ltm),
            "relpose": _bucket(n_frames + 1),
            "n_pose": pose_cap,
            "n_point": _bucket(max(feats, 1)),
            "pt_pair": _round_up(pairs),
            "pt_cross": _round_up(cross),
            "pt_dest": _round_up(min(cross, (n_frames + 1) ** 2)),
            "pt_slot_land": _round_up(feats),
            "pt_slot_c": _round_up(max_frames_per_track, bucket=4),
            # What a build with no boxes and no band layout gives, so that
            # the key set is the same from the first build.
            "n_obj": _bucket(1, minimum=8),
            "ob_pair": _round_up(0),
            "ob_cross": _round_up(0),
            "ob_dest": _round_up(0),
            "ob_slot_land": _round_up(0),
            "ob_slot_c": _round_up(0, bucket=4),
            "pt_band_lg": 0,
            "rel_band_lg": 0,
        }
        # One object per raw box. The reference means to divide by the
        # association's min_observations, but reads it from a config
        # attribute that does not exist and so divides by 1; the port keeps
        # its numbers. The LTM's objects are in the graph from the start.
        n_obj = bbs + n_ltm
        if n_obj:
            seed.update(n_obj=_bucket(n_obj, minimum=8), shape=_bucket(n_obj))
        if bbs:
            # The plan keeps one pair per (pose, object), so an object has at
            # most n_frames + 1 pairs and at most as many as its boxes:
            # sum(pairs_o^2) <= bbs * (n_frames + 1).
            ob_cross = min(bbs * bbs, bbs * (n_frames + 1))
            seed.update(
                ob_pair=_round_up(bbs),
                ob_cross=_round_up(ob_cross),
                ob_dest=_round_up(min(ob_cross, (n_frames + 1) ** 2)),
                ob_slot_land=_round_up(n_obj),
                ob_slot_c=_round_up(min(bbs, n_frames + 1), bucket=4),
            )
        if pose_cap >= 3 * BAND_TP and band_ok and tile_counts:
            # The band layout engages at this pose capacity: its group sizes
            # (128-row steps; the relpose band holds <= 64 relpose and 64
            # diagonal rows per group, plan._rel_band_layout).
            seed["pt_band_lg"] = -(-max(tile_counts.values()) // 128) * 128
            seed["rel_band_lg"] = 128
        return seed

    def _seed_pool(self, key: str, seed: Dict[str, int]) -> dict:
        pool = self.caps_pool(key)
        for k, v in seed.items():
            pool[k] = max(pool.get(k, 0), int(v))
        return pool

    def presize_local_caps(self, data: OfflineProblemData, n_ltm: int = 0) -> dict:
        """Seeds the "local" pool from the first full window's raw counts
        (frames [0, local_ba_window_size]), so that the growing windows of
        the first frames share one shape."""
        w = self.config.sliding_window_params.local_ba_window_size
        return self._seed_pool("local", self._window_caps_seed(data, 0, w, n_ltm))

    def presize_session_caps(
        self, data: OfflineProblemData, max_frame_id: Optional[int] = None, n_ltm: int = 0
    ) -> dict:
        """Seeds every session pool from the raw counts of the session's
        frames, so that each solve family runs at the session's capacities
        from its first problem: "local" from the first window, "global"
        from frames [0, max_frame_id], and with PGO on global BA "pgo" and
        "pgo_vf" as "global" and "pgo_tracking" from the largest tracking
        window (poses_prior_to_window_to_keep_constant + 1 frames) at each
        global-BA frequency step. Padding rows are masked, so the results
        equal an unseeded session's up to roundoff. The seeds read the raw
        data and ``n_ltm``, the objects seeded from a long-term map, only:
        the ranks of a mesh agree without a collective."""
        if max_frame_id is None:
            max_frame_id = data.max_frame_id()
        self.presize_local_caps(data, n_ltm)
        session = self._window_caps_seed(data, 0, max_frame_id, n_ltm)
        self._seed_pool("global", session)
        en = self.config.optimization_factors_enabled_params
        if en.use_pose_graph_on_global_ba or en.use_pose_graph_on_final_global_ba:
            self._seed_pool("pgo", session)
            self._seed_pool("pgo_vf", session)
            n_const = max(1, en.poses_prior_to_window_to_keep_constant)
            step = max(1, self.config.sliding_window_params.global_ba_frequency)
            track_seed: Dict[str, int] = {}
            for f in range(0, max_frame_id + 1, step):
                ws = self._window_caps_seed(
                    data, max(0, f - n_const), min(f, max_frame_id), n_ltm
                )
                for k, v in ws.items():
                    track_seed[k] = max(track_seed.get(k, 0), v)
            self._seed_pool("pgo_tracking", track_seed)
        return self._caps_pools

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

    def _fused(self) -> bool:
        """Whether the solves take the fused path (see the class docstring)."""
        if self.mesh is not None:
            return False
        if self.use_fused_solver is None:
            return torch.device(self.device).type == "cuda"
        return bool(self.use_fused_solver)

    def _with_records(self) -> bool:
        """Whether a fused solve returns its IterationRecords: when a solve
        logger or the optimization logger reads them, as the reference."""
        return (self.hooks.solve_logger is not None
                or optlog.IterationLoggerFactory.instance().enabled)

    def solve(self, problem: Problem, params: LMParams, weights=None, mesh=None):
        """One LM solve of a built Problem: (final_state, LMSummary). With
        ``mesh`` the problem (and ``weights``) is the rank's shard."""
        args = (problem.state, problem.cams, problem.tables, problem.plan, problem.free,
                problem.weights if weights is None else weights, params, problem.huber)
        if self._fused():
            state, summary = solve_fused(*args, with_records=self._with_records(),
                                         plain=self.plain)
        else:
            state, summary = solve(*args, plain=self.plain, mesh=mesh)
        return self._agree(state), summary

    def _solve_mesh(self, global_ba: bool):
        """The mesh a BA problem is sharded on, or None."""
        if self.mesh is not None and (global_ba or self.shard_local_ba):
            return self.mesh
        return None

    def _agree(self, state):
        """Rank 0's state on every rank (a no-op without a mesh)."""
        if self.mesh is None:
            return state
        flat = comm.broadcast(torch.cat([x.reshape(-1) for x in state]), self.mesh)
        parts = torch.split(flat, [x.numel() for x in state])
        return type(state)(*(p.reshape(x.shape) for p, x in zip(parts, state)))

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
        set_frame(frame_to_add)
        with timer("frame_pose_add"):
            self._add_frame_pose(data, pg, frame_to_add)
        if self.visual_frontend is not None:
            with timer("visual_frontend_add_obs"):
                self.visual_frontend.add_visual_feature_observations(
                    data, pg, min_frame_id, frame_to_add
                )
        if self.hooks.bb_frontend is not None:
            with timer("bb_frontend_hook"):
                self.hooks.bb_frontend(data, pg, frame_to_add)
        if self.hooks.frame_data_extra is not None:
            self.hooks.frame_data_extra(pg, frame_to_add)

    def _add_frame_pose(self, data: OfflineProblemData, pg: PoseGraph, frame_to_add):
        """The frame's pose and its odometry factor."""
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
        set_frame(next_frame_id)
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
            mesh = self._solve_mesh(global_ba)
            with timer(f"phase_one_{tag}_build_opt"):
                problem = self._build_problem(pg, scope, key)
                shard = problem if mesh is None else sharding.shard_problem(problem, mesh)
            with timer("window_ba_write_back"):
                snapshot = pg.snapshot_values()
            if two_phase and self.use_fused_solver is not False:
                # Both phases in one call; the timer covers both.
                with timer(f"phase_one_{tag}_solve_opt"):
                    state, s1, s2 = self._solve_two_phase(shard, iteration_params, mesh)
                self._log_solve(problem, s1, next_frame_id, global_ba, 1, attempt_num)
                self._log_solve(problem, s2, next_frame_id, global_ba, 2, attempt_num)
            elif two_phase:
                state = self._solve_two_phase_host(
                    pg, problem, snapshot, iteration_params, tag, next_frame_id, global_ba,
                    attempt_num, shard, mesh,
                )
            else:
                with timer(f"phase_one_{tag}_solve_opt"):
                    state, summary = self.solve(
                        shard, lm_params_from_config(iteration_params.phase_one_opt_params),
                        mesh=mesh,
                    )
                self._log_solve(problem, summary, next_frame_id, global_ba, 1, attempt_num)
            with timer("window_ba_write_back"):
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

    def _solve_two_phase(self, problem: Problem, iteration_params, mesh=None):
        """Phase 1, re-selection and phase 2 of one window iteration (on the
        rank's shard with ``mesh``)."""
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
        args = (problem.state, problem.cams, problem.tables, problem.plan, problem.free,
                problem.weights, problem.aux,
                lm_params_from_config(iteration_params.phase_one_opt_params),
                lm_params_from_config(iteration_params.phase_two_opt_params),
                problem.huber, tp_cfg)
        if self._fused():
            state, s1, s2 = solve_two_phase_fused(
                *args, with_records=self._with_records(), plain=self.plain)
        else:
            state, s1, s2 = solve_two_phase(*args, plain=self.plain, mesh=mesh)
        return self._agree(state), s1, s2

    def _solve_two_phase_host(
        self, pg, problem, snapshot, iteration_params, tag, frame_id, global_ba, attempt,
        shard=None, mesh=None,
    ):
        """The reference's host loop of a two-phase window: phase-1 solve,
        the worst ``feature_outlier_percentage`` of live reprojection and
        bounding-box rows ranked on the host (stable argsort of the squared
        residuals, the f32 floor(n_live * pct) count, as the device pass),
        the values restored, the phase-2 weights from the exclusion set, and
        the phase-2 solve from the window's input values. Returns the final
        state. With ``mesh`` the solves take the rank's ``shard`` and the
        ranking reads the whole ``problem``."""
        shard = problem if shard is None else shard
        with timer(f"phase_one_{tag}_solve_opt"):
            state, summary = self.solve(
                shard, lm_params_from_config(iteration_params.phase_one_opt_params), mesh=mesh
            )
        self._log_solve(problem, summary, frame_id, global_ba, 1, attempt)

        res = fac.all_residuals(state, problem.cams, problem.tables,
                                problem.huber.invalid_ellipse_error)
        pct = np.float32(iteration_params.feature_outlier_percentage)
        excluded = set()
        for ftype, key, rows in (
            (REPROJECTION_FACTOR, "reproj", problem.reproj_rows),
            (OBJECT_OBSERVATION_FACTOR, "bbox", problem.bbox_rows),
        ):
            r = res[key].detach().cpu().numpy()[: len(rows)]
            sq = np.sum(r * r, axis=1)
            live = np.nonzero(problem.base_weights_np[key] > 0)[0]
            n_out = int(np.floor(np.float32(len(live)) * pct))
            if n_out > 0:
                worst = live[np.argsort(-sq[live], kind="stable")[:n_out]]
                excluded.update((ftype, int(rows[i])) for i in worst)

        pg.restore_values(snapshot)
        with timer(f"phase_two_{tag}_build_opt"):
            weights2 = reweight_for_exclusions(pg, problem, excluded)
            if mesh is not None:
                weights2 = sharding.shard_weights(weights2, mesh)
        with timer(f"phase_two_{tag}_solve_opt"):
            state, summary = self.solve(
                shard, lm_params_from_config(iteration_params.phase_two_opt_params),
                weights=weights2, mesh=mesh,
            )
        self._log_solve(problem, summary, frame_id, global_ba, 2, attempt)
        return state

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
        if not self.is_rank0:
            return
        # As the reference's: a PGO solve (phase 0) is logged under the
        # phase-2 type too.
        if global_ba:
            opt_type = optlog.GBA_PHASE1_TYPE if phase == 1 else optlog.GBA_PHASE2_TYPE
        else:
            opt_type = optlog.LBA_PHASE1_TYPE if phase == 1 else optlog.LBA_PHASE2_TYPE
        log_iterations(opt_type, frame_id, summary, problem)
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
            self.presize_session_caps(data, max_frame_id, n_ltm=len(pg.ltm_object_ids))
            if start_at_frame == 0 and add_data_for_starting_frame:
                self.add_frame_data(data, pg, 0, 0)
            for next_frame_id in range(max(1, start_at_frame), max_frame_id + 1):
                set_frame(next_frame_id)
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
        return self.run_offline_portion(data, pg, max_frame_id)

    def run_offline_portion(self, data: OfflineProblemData, pg: PoseGraph, max_frame_id) -> bool:
        """The session's end after its last frame: the final optimization
        over the whole trajectory, then the merge loop."""
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
        if self.hooks.checkpoint is not None and self.is_rank0:
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
        min_parallax_transl=vp.min_visual_feature_parallax_robot_transl_requirement,
        min_parallax_orient=vp.min_visual_feature_parallax_robot_orient_requirement,
        enforce_pixel_parallax=vp.enforce_min_pixel_parallax_requirement,
        enforce_pose_parallax=vp.enforce_min_robot_pose_parallax_requirement,
        inlier_epipolar_err_thresh=vp.inlier_epipolar_err_thresh,
        check_past_n_frames=vp.check_past_n_frames_for_epipolar_err,
        enforce_epipolar=vp.enforce_epipolar_error_requirement,
    )
