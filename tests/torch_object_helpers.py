"""Shared helpers of the tests that hold the port's object pipeline
(bounding-box frontend, PGO, LTM) against the JAX package at f64 on CPU.

Configs are ``FullOVSLAMConfig()`` of each package plus the overrides of the
reference's object and PGO tests and a ``chair`` shape prior (the default
config has none). Both runners run the same numpy session: the JAX one on its
fused solver path without device sync, its pending-object mini-BA on the
fused solver too (the path it takes on an accelerator); the port's on the
CPU.

A chained session cannot be held to the reference at 1e-6. On
``make_object_session`` the chairs are symmetric about their yaw axis, which
is the cameras' optical axis there, so the ellipsoid yaw is unobservable from
boxes and the reference's own LM steps along it on roundoff (the yaw wanders
by many turns): even one window solve replayed on identical inputs ends far
apart. With asymmetric chairs (``ASYM_DIMS``, the prior's mean too) every
replayed solve agrees, but the yaw stays weakly observable (first order only
through the small pose rotations), and a chained session still drifts apart
after a few frames. So each solve the JAX
runner makes is recorded (``SolveRecorder``) and replayed through the port's
solver on the same inputs (``replay``), on the asymmetric-chair session; the
two chained sessions are compared in their structure and held to the
reference tests' own gates.
"""

import contextlib
import dataclasses

import numpy as np

import obvi_slam_tpu.solver as jsolver
from obvi_slam_tpu import optlog as joptlog
from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import runner as jrunner
from obvi_slam_tpu.frontend import FeatureBasedBoundingBoxFrontEnd as JaxBbFrontEnd
from obvi_slam_tpu.frontend import VisualFeatureFrontend as JaxVisualFrontend
from obvi_slam_tpu.frontend import apply_merges as jax_apply_merges
from obvi_slam_tpu.frontend import make_bb_frontend_hook as jax_bb_hook
from obvi_slam_tpu.frontend import merge_objects_by_center_proximity as jax_merges
from obvi_slam_tpu.ltm import seed_pose_graph_from_ltm as jax_seed
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.solver import lm_fused
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch import frontend as pfrontend

IMG_HW = {1: (480.0, 640.0)}
CHAIR_DIMS = (0.62, 0.62, 0.975)
ASYM_DIMS = (0.5, 0.8, 0.975)


def add_chair_prior(c, module, dims=CHAIR_DIMS):
    """The chair prior of the reference's default configuration writer (mean
    ``dims``)."""
    c.shape_dimension_priors = [
        module.ShapeDimensionPrior("chair", np.array(dims), np.diag([0.05**2] * 3))
    ]
    return c


def object_config(module=jcfg, dims=CHAIR_DIMS):
    """tests/test_bb_frontend.py::object_config's overrides on the default."""
    c = module.FullOVSLAMConfig()
    c.sliding_window_params.local_ba_window_size = 6
    c.sliding_window_params.global_ba_frequency = 5
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = False
    en.use_pose_graph_on_final_global_ba = False
    en.use_visual_features_on_global_ba = True
    en.use_visual_features_on_final_global_ba = True
    en.min_low_level_feature_observations_per_frame = 10
    en.min_low_level_feature_observations = 3
    en.min_object_observations = 3
    fe = c.feature_based_bb_association_params
    fe.min_observations = 5
    fe.min_observations_for_local_est = 3
    fe.min_overlapping_features_for_match = 3.0
    for p in (c.local_ba_iteration_params, c.global_ba_iteration_params,
              c.final_ba_iteration_params):
        p.phase_one_opt_params.max_num_iterations = 15
        p.phase_two_opt_params.max_num_iterations = 20
    fe.pending_obj_estimator_params.solver_params.max_num_iterations = 30
    return add_chair_prior(c, module, dims)


def pgo_object_config(module=jcfg, dims=CHAIR_DIMS):
    """object_config with tests/test_pgo.py::pgo_config's PGO schedule."""
    c = object_config(module, dims)
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = True
    en.use_pose_graph_on_final_global_ba = True
    en.use_visual_features_on_global_ba = False
    en.use_visual_features_on_final_global_ba = True
    pgo = c.pgo_solver_params
    pgo.pgo_optimization_solver_params.max_num_iterations = 20
    pgo.final_pgo_optimization_solver_params.max_num_iterations = 25
    pgo.post_pgo_vf_adjustment_solver_params.max_num_iterations = 15
    pgo.final_post_pgo_vf_adjustment_solver_params.max_num_iterations = 20
    return c


@contextlib.contextmanager
def jax_fused_mini_ba():
    """The JAX mini-BA takes its host LM loop on CPU and the fused loop on an
    accelerator; the port mirrors the fused loop."""
    host = jsolver.solve
    jsolver.solve = lambda *a, **k: lm_fused.solve_fused(*a, **k)
    try:
        yield
    finally:
        jsolver.solve = host


def jax_frontend(pg, config):
    return JaxBbFrontEnd(
        pg, config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params, img_heights_and_widths=IMG_HW,
    )


def port_frontend(pg, config):
    return pfrontend.FeatureBasedBoundingBoxFrontEnd(
        pg, config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params, img_heights_and_widths=IMG_HW,
        device="cpu",
    )


def _merger(config, fe, merges, apply):
    p = config.post_session_object_merge_params
    return lambda pg: apply(pg, merges(pg, p.max_merge_distance, p.x_y_only_merge), fe)


class SolveRecorder:
    """Records every LM solve of a JAX runner and of its frontend's mini-BA:
    (kind, inputs, outputs) with the reference's arrays; and every problem
    the runner builds: (pose-graph state, scope, pool key, caps before the
    build, build keywords, problem)."""

    def __init__(self, runner):
        self.records, self.builds = [], []
        solve, two_phase = runner.solve, runner._solve_two_phase_fused
        build = runner.build_problem_synced

        def rec_build(pg, scope, key, **kw):
            state, pool = pg.get_state(), dict(runner.caps_pool(key))
            problem = build(pg, scope, key, **kw)
            self.builds.append((state, scope, key, pool, kw, problem))
            return problem

        def rec_solve(problem, params, weights=None):
            out = solve(problem, params, weights)
            w = problem.weights if weights is None else weights
            self.records.append(("solve", (_problem_args(problem, w), params), out))
            return out

        def rec_two_phase(problem, iteration_params, global_ba):
            out = two_phase(problem, iteration_params, global_ba)
            self.records.append(
                ("two_phase", (_problem_args(problem, problem.weights), problem.aux,
                               iteration_params, problem.scope), out)
            )
            return out

        runner.solve = rec_solve
        runner._solve_two_phase_fused = rec_two_phase
        runner.build_problem_synced = rec_build

    def mini_ba(self, state, cams, tables, plan, free, params, huber):
        """The fused solve, with per-iteration records when the optimization
        logger is on (the JAX frontend's accelerator branch)."""
        out = lm_fused.solve_fused(
            state, cams, tables, plan, free, params=params, huber=huber,
            with_records=joptlog.IterationLoggerFactory.instance().enabled)
        weights = jsolver.schur.ones_weights(tables, dtype=state.poses.dtype)
        self.records.append(
            ("solve", ((state, cams, tables, plan, free, weights, huber), params), out)
        )
        return out


def _problem_args(problem, weights):
    return (problem.state, problem.cams, problem.tables, problem.plan, problem.free, weights,
            problem.huber)


def replay(record):
    """The port's solve on a recorded JAX solve's inputs: (state, summaries)."""
    from obvi_slam_tpu_torch import convert
    from obvi_slam_tpu_torch.runner import lm_params_from_config

    kind, inputs, _ = record
    args = inputs[0]
    state, cams, tables, plan, free, weights = (
        convert.to_torch(x, device="cpu") for x in args[:6]
    )
    huber = ot.solver.HuberParams(*args[6])
    if kind == "solve":
        params = ot.LMParams(**dataclasses.asdict(inputs[1]))
        final, summary = ot.solve(state, cams, tables, plan, free, weights, params, huber)
        return final, (summary,)
    aux, it_params, sc = convert.to_torch(inputs[1], device="cpu"), inputs[2], inputs[3]
    tp_cfg = ot.TwoPhaseConfig(
        feature_outlier_percentage=float(it_params.feature_outlier_percentage),
        min_low_level_feature_observations=int(sc.min_low_level_feature_observations),
        min_low_level_feature_observations_per_frame=int(
            sc.min_low_level_feature_observations_per_frame),
        min_object_observations=int(sc.min_object_observations),
        include_visual_factors=bool(sc.include_visual_factors),
        include_object_factors=bool(sc.include_object_factors),
        include_shape_priors=bool(sc.include_shape_priors),
        fix_objects=bool(sc.fix_objects),
        fix_ltm_objects=bool(sc.fix_ltm_objects),
        force_include_ltm_objs=bool(sc.force_include_ltm_objs),
    )
    final, s1, s2 = ot.solve_two_phase(
        state, cams, tables, plan, free, weights, aux,
        lm_params_from_config(it_params.phase_one_opt_params),
        lm_params_from_config(it_params.phase_two_opt_params), huber, tp_cfg,
    )
    return final, (s1, s2)


def _roundoff_tail(summary):
    """True when the solve's last accepted step changed the cost by less than
    1e-12 of it: accepting or rejecting such a step is a roundoff tie, so
    the iteration count may differ by the tie (the states still agree)."""
    acc = [it for it in summary.iterations if it.accepted]
    return bool(acc) and abs(acc[-1].cost_change) <= 1e-12 * acc[-1].cost


def assert_replays_match(records, rtol=1e-6, atol=1e-9):
    """Every recorded JAX solve, replayed through the port: equal iteration
    counts and terminations (see ``_roundoff_tail``), costs and final states
    within ``rtol``."""
    assert records
    for i, record in enumerate(records):
        final, summaries = replay(record)
        ref_state, ref_summaries = record[2][0], record[2][1:]
        for ours, ref in zip(summaries, ref_summaries):
            assert ours.termination == ref.termination, (i, record[0], ours, ref)
            if ours.num_iterations != ref.num_iterations:
                assert _roundoff_tail(ours) and abs(
                    ours.num_iterations - ref.num_iterations) == 1, (i, record[0], ours, ref)
            np.testing.assert_allclose(
                [ours.initial_cost, ours.final_cost], [ref.initial_cost, ref.final_cost],
                rtol=rtol, atol=1e-20, err_msg=f"solve {i}")
        for name, a, b in zip(ref_state._fields, final, ref_state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                       err_msg=f"solve {i} {name}")


def to_jax_data(data):
    """The port's OfflineProblemData as the reference's (same arrays)."""
    from obvi_slam_tpu.offline_data import OfflineProblemData, RawBoundingBox
    from obvi_slam_tpu.pose_graph import CameraInfo

    return OfflineProblemData(
        cameras={c: CameraInfo(v.intrinsics, v.extrinsics_r, v.extrinsics_t)
                 for c, v in data.cameras.items()},
        feature_tracks=data.feature_tracks,
        feature_init_positions=data.feature_init_positions,
        initial_poses=data.initial_poses,
        bounding_boxes={
            f: {c: [RawBoundingBox(b.corners, b.semantic_class, b.detection_confidence)
                    for b in bbs] for c, bbs in by_cam.items()}
            for f, by_cam in data.bounding_boxes.items()
        },
    )


def run_jax_session(data, config, ltm=None):
    """(runner, pg, frontend, recorder) of the JAX object session (see the
    module doc); ``recorder.records`` holds its solves."""
    pg = JaxPoseGraph(data.cameras, jcfg.shape_prior_map(config))
    if ltm is not None:
        jax_seed(pg, ltm)
    fe = jax_frontend(pg, config)
    hooks = jrunner.RunnerHooks(
        bb_frontend=jax_bb_hook(fe), object_merger=_merger(config, fe, jax_merges, jax_apply_merges)
    )
    runner = jrunner.OfflineProblemRunner(
        config, hooks, use_fused_solver=True, use_device_sync=False
    )
    recorder = SolveRecorder(runner)
    vf = JaxVisualFrontend(
        gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
        reprojection_error_provider=lambda *a: 1.0,
    )
    host = jsolver.solve
    jsolver.solve = recorder.mini_ba
    try:
        assert runner.run_optimization(data, pg, visual_frontend=vf)
    finally:
        jsolver.solve = host
    return runner, pg, fe, recorder


def run_port_session(data, config, ltm=None):
    """(runner, pg, frontend) of the port's object session on the CPU."""
    pg = ot.PoseGraph(data.cameras, pcfg.shape_prior_map(config))
    if ltm is not None:
        ot.seed_pose_graph_from_ltm(pg, ltm)
    fe = port_frontend(pg, config)
    hooks = ot.runner.RunnerHooks(
        bb_frontend=pfrontend.make_bb_frontend_hook(fe),
        object_merger=_merger(config, fe, pfrontend.merge_objects_by_center_proximity,
                              pfrontend.apply_merges),
    )
    runner = ot.OfflineProblemRunner(config, hooks, device="cpu")
    vf = ot.VisualFeatureFrontend(
        gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
        reprojection_error_provider=lambda *a: 1.0,
    )
    assert runner.run_optimization(data, pg, visual_frontend=vf)
    return runner, pg, fe


def assert_same_schedule(ours, ref):
    """The two chained sessions made the same solves: frame, global BA,
    phase, attempt and window sizes of every solve record."""
    def key(r):
        return (r.frame_id, r.global_ba, r.phase, r.attempt, r.num_poses, r.num_objects)

    assert [key(r) for r in ours] == [key(r) for r in ref]


def trajectory(pg, n):
    return np.stack([pg.get_robot_pose(i) for i in range(n)])


def ellipsoids(pg):
    return {o: (n.semantic_class, n.ellipsoid) for o, n in pg.objects.items()}


def assert_same_objects(pg_ours, pg_ref, rtol=1e-6, atol=1e-9, values=True):
    """Equal object ids, classes and observation lists; with ``values``,
    ellipsoids within ``rtol``."""
    ours, ref = ellipsoids(pg_ours), ellipsoids(pg_ref)
    assert ours.keys() == ref.keys()
    for o in ref:
        assert ours[o][0] == ref[o][0]
        if values:
            np.testing.assert_allclose(ours[o][1], ref[o][1], rtol=rtol, atol=atol,
                                       err_msg=str(o))
    assert pg_ours.obj_obs_by_object.keys() == pg_ref.obj_obs_by_object.keys()
    for o, obs in pg_ref.obj_obs_by_object.items():
        assert list(pg_ours.obj_obs_by_object[o]) == list(obs)
