"""The visual-only OfflineProblemRunner of obvi_slam_tpu_torch against the
JAX package's at f64 on CPU: window policy, odometry covariance, the config's
JSON round trip, the synthetic session, window problems at equal caps, and a
whole session (solve records, terminations, trajectory, timers)."""

import dataclasses

import numpy as np
import pytest
import torch

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import runner as jrunner
from obvi_slam_tpu.frontend import VisualFeatureFrontend as JaxFrontend
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.solver import problem as jproblem
from obvi_slam_tpu.timing import TimerRegistry as JaxTimers
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import runner as prunner
from obvi_slam_tpu_torch.solver import problem as pproblem
from obvi_slam_tpu_torch.timing import TimerRegistry
from test_runner_e2e import ate_rmse, make_session
from torch_port_helpers import npy

torch.set_num_threads(1)

SESSION = dict(n_frames=8, n_features=30)


def small_config(module=jcfg):
    """FullOVSLAMConfig() with the overrides of the reference's runner tests
    (tests/test_runner_e2e.py::small_config)."""
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
    en.poses_prior_to_window_to_keep_constant = 1
    for p in (c.local_ba_iteration_params, c.global_ba_iteration_params,
              c.final_ba_iteration_params):
        p.phase_one_opt_params.max_num_iterations = 20
        p.phase_two_opt_params.max_num_iterations = 30
    return c


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    """The reference writes the config; the port reads it."""
    path = tmp_path_factory.mktemp("config") / "small.json"
    jcfg.write_config(small_config(), str(path))
    return str(path)


def _assert_same_fields(a, b, path="config"):
    """Equal dataclass trees (numpy arrays compared by value)."""
    if dataclasses.is_dataclass(b):
        _assert_same_fields(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_same_fields(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_fields(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_config_round_trips_json(config_path, tmp_path):
    """Reference JSON -> port config -> JSON -> reference config, unchanged."""
    ours = ot.config.read_config(config_path)
    _assert_same_fields(ours, small_config())
    ot.config.write_config(ours, str(tmp_path / "back.json"))
    _assert_same_fields(jcfg.read_config(str(tmp_path / "back.json")), small_config())


def test_both_runners_meet_the_e2e_gates():
    """tests/test_runner_e2e.py::test_full_run_reduces_ate's gates on this
    config and its session: the JAX runner as that test runs it, and the
    port's."""
    data, gt, _ = make_session()
    ate_init = np.sqrt(np.mean([
        np.sum((data.initial_poses[i][:3] - gt[i, :3]) ** 2) for i in range(len(gt))
    ]))
    config = small_config()
    jax_runner = jrunner.OfflineProblemRunner(config)
    jax_pg = JaxPoseGraph(data.cameras)
    assert jax_runner.run_optimization(
        data, jax_pg, visual_frontend=_jax_frontend(jax_runner, config, data)
    )
    ours_data, _, _ = ot.synthetic_session()
    runner = ot.OfflineProblemRunner(small_config(ot.config), device="cpu")
    pg = ot.PoseGraph(ours_data.cameras)
    assert runner.run_optimization(
        ours_data, pg, visual_frontend=prunner.visual_frontend_for(runner, ours_data)
    )
    for pg, runner in ((jax_pg, jax_runner), (pg, runner)):
        ate_final = ate_rmse(pg, gt)
        assert ate_final < ate_init * 0.5, (ate_init, ate_final)
        assert ate_final < 0.05, ate_final
        assert pg.max_frame_id() == data.max_frame_id()
        assert len(pg.features) > 10
        assert {r.phase for r in runner.opt_log} == {1, 2}


@pytest.mark.parametrize("frame,max_frame,expected", [
    (100, 100, 0), (90, 100, 0), (40, 100, 0), (77, 100, 27), (31, 100, 0), (51, 100, 1),
])
def test_provide_optimization_window_matches_jax(frame, max_frame, expected):
    sw = jcfg.SlidingWindowParams(global_ba_frequency=30, local_ba_window_size=50)
    ours = prunner.provide_optimization_window(
        frame, max_frame, ot.config.SlidingWindowParams(global_ba_frequency=30,
                                                        local_ba_window_size=50))
    assert ours == jrunner.provide_optimization_window(frame, max_frame, sw) == expected


def test_generate_odom_cov_matches_jax():
    rng = np.random.default_rng(0)
    params = small_config().object_visual_pose_graph_residual_params.relative_pose_cov_params
    ours_params = ot.config.RelativePoseCovParams(**dataclasses.asdict(params))
    for rel in [np.zeros(6), *rng.normal(size=(5, 6)) * [0.3, 0.3, 0.3, 0.05, 0.05, 0.05]]:
        np.testing.assert_array_equal(
            prunner.generate_odom_cov(rel, ours_params), jrunner.generate_odom_cov(rel, params)
        )


def test_synthetic_session_equals_make_session():
    kw = dict(n_frames=6, n_features=25, seed=3)
    data, gt_poses, gt_points = ot.synthetic_session(**kw)
    ref, ref_poses, ref_points = make_session(**kw)
    np.testing.assert_array_equal(gt_poses, ref_poses)
    np.testing.assert_array_equal(gt_points, ref_points)
    assert data.cameras.keys() == ref.cameras.keys()
    for c in data.cameras:
        for field in ("intrinsics", "extrinsics_r", "extrinsics_t"):
            np.testing.assert_array_equal(getattr(data.cameras[c], field),
                                          getattr(ref.cameras[c], field))
    assert data.feature_tracks.keys() == ref.feature_tracks.keys()
    for j, track in data.feature_tracks.items():
        assert track.keys() == ref.feature_tracks[j].keys()
        for i, obs in track.items():
            assert obs.keys() == ref.feature_tracks[j][i].keys()
            for cam, px in obs.items():
                np.testing.assert_array_equal(px, ref.feature_tracks[j][i][cam])
    for name in ("feature_init_positions", "initial_poses"):
        ours, theirs = getattr(data, name), getattr(ref, name)
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_unported_options_raise():
    """The multi-device runner and the host-loop two-phase branch raise (PGO
    on global BA runs: tests/test_torch_pgo.py)."""
    c = small_config(ot.config)
    for kw in (dict(mesh=object()), dict(shard_local_ba=True), dict(use_fused_solver=False)):
        with pytest.raises(NotImplementedError):
            ot.OfflineProblemRunner(c, device="cpu", **kw)


def _jax_frontend(runner, config, data):
    vp = config.visual_feature_params
    return JaxFrontend(
        gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
        reprojection_error_provider=lambda *a: vp.reprojection_error_std_dev,
        min_parallax_pixel=vp.min_visual_feature_parallax_pixel_requirement,
        inlier_epipolar_err_thresh=vp.inlier_epipolar_err_thresh,
        check_past_n_frames=vp.check_past_n_frames_for_epipolar_err,
    )


def _trajectory(pg, n):
    return np.stack([pg.get_robot_pose(i) for i in range(n)])


class TestSessionAgainstJax:
    """One session through both runners: the JAX one on its fused solver
    path, without device sync and with presize_session_caps stubbed (as
    tests/test_runner_e2e.py's unpresized run), the port's on the CPU."""

    @pytest.fixture(scope="class")
    def sessions(self, config_path):
        data, gt_poses, _ = make_session(**SESSION)
        config = small_config()
        jax_runner = jrunner.OfflineProblemRunner(
            config, use_fused_solver=True, use_device_sync=False
        )
        jax_runner.presize_session_caps = lambda *a, **k: jax_runner._caps_pools
        builds = []
        inner = jax_runner.build_problem_synced

        def record(pg, scope, key, **kw):
            state, pool = pg.get_state(), dict(jax_runner.caps_pool(key))
            problem = inner(pg, scope, key, **kw)
            builds.append((state, scope, pool, problem))
            return problem

        jax_runner.build_problem_synced = record
        jax_pg = JaxPoseGraph(data.cameras)
        assert jax_runner.run_optimization(
            data, jax_pg, visual_frontend=_jax_frontend(jax_runner, config, data)
        )

        TimerRegistry.instance().reset()
        ours_data, _, _ = ot.synthetic_session(**SESSION)
        runner = ot.OfflineProblemRunner(ot.config.read_config(config_path), device="cpu")
        pg = ot.PoseGraph(ours_data.cameras)
        assert runner.run_optimization(
            ours_data, pg, visual_frontend=prunner.visual_frontend_for(runner, ours_data)
        )
        return dict(data=data, gt=gt_poses, jax_runner=jax_runner, jax_pg=jax_pg,
                    runner=runner, pg=pg, builds=builds)

    def test_solve_records_match(self, sessions):
        ours, ref = sessions["runner"].opt_log, sessions["jax_runner"].opt_log
        assert len(ours) == len(ref) > 2
        for a, b in zip(ours, ref):
            assert (a.frame_id, a.global_ba, a.phase, a.attempt) == (
                b.frame_id, b.global_ba, b.phase, b.attempt)
            assert a.termination == b.termination, (a, b)
            assert (a.num_poses, a.num_features, a.num_objects) == (
                b.num_poses, b.num_features, b.num_objects)
            np.testing.assert_allclose(a.final_cost, b.final_cost, rtol=1e-6, atol=1e-20)

    def test_trajectory_matches(self, sessions):
        n = sessions["data"].max_frame_id() + 1
        np.testing.assert_allclose(
            _trajectory(sessions["pg"], n), _trajectory(sessions["jax_pg"], n),
            rtol=1e-6, atol=1e-9,
        )
        assert sessions["runner"]._caps_pools == sessions["jax_runner"]._caps_pools

    @pytest.mark.parametrize("which", ["first", "final"])
    def test_window_problem_equals_jax(self, sessions, which):
        """The first window's and the final global BA's problem, built by the
        port from the reference's pose graph at the reference's caps."""
        state, scope, pool, ref = sessions["builds"][0 if which == "first" else -1]
        data = sessions["data"]
        pg = ot.PoseGraph.from_state(
            state, {c: ot.pose_graph.CameraInfo(**dataclasses.asdict(v))
                    for c, v in data.cameras.items()}
        )
        config = sessions["runner"].config
        ours = pproblem.build_problem(
            pg, pproblem.Scope(**dataclasses.asdict(scope)),
            config.object_visual_pose_graph_residual_params,
            dtype=np.float64, caps=pool, device="cpu",
        )
        assert pproblem.observed_caps(ours) == jproblem.observed_caps(ref)
        for name in ("state", "cams", "tables", "plan", "free", "weights", "aux", "huber"):
            _assert_trees_equal(getattr(ours, name), getattr(ref, name), name)
        for name in ("pose_rows", "point_rows", "obj_rows", "reproj_rows", "bbox_rows",
                     "relpose_rows", "shape_rows", "ltm_rows"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), name)
        for k, v in ref.base_weights_np.items():
            np.testing.assert_array_equal(ours.base_weights_np[k], v, k)

    def test_timers_under_reference_names(self, sessions):
        ours = set(TimerRegistry.instance().timers)
        ref = set(JaxTimers.instance().timers)
        for name in ("frame_data_adder", "optimization_iteration", "global_bundle_adjustment",
                     "phase_one_gba_build_opt", "phase_one_gba_solve_opt",
                     "offline_runner_online_portion", "offline_runner_offline_portion"):
            assert name in ours and name in ref, (name, ours, ref)


def _assert_trees_equal(ours, ref, path):
    if ref is None:
        assert ours is None, path
        return
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        assert ours._fields == ref._fields, path
        for name in ref._fields:
            _assert_trees_equal(getattr(ours, name), getattr(ref, name), f"{path}.{name}")
        return
    if isinstance(ref, (int, float)):
        assert ours == ref, path
        return
    a, b = npy(ours), np.asarray(ref)
    assert a.dtype == b.dtype, f"{path}: {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def jax_f32_session():
    """The 8-frame session at f32 through the JAX runner (its fused path, on
    the CPU, with per-iteration records on), every solve recorded."""
    from obvi_slam_tpu.solver import lm_fused
    from torch_object_helpers import SolveRecorder

    data, _, _ = make_session(**SESSION)
    config = small_config()
    fused = lm_fused.solve_two_phase_fused
    lm_fused.solve_two_phase_fused = lambda *a, **k: fused(*a, **dict(k, with_records=True))
    try:
        jax_runner = jrunner.OfflineProblemRunner(
            config, dtype=np.float32, use_fused_solver=True, use_device_sync=False
        )
        jax_runner.presize_session_caps = lambda *a, **k: jax_runner._caps_pools
        recorder = SolveRecorder(jax_runner)
        jax_pg = JaxPoseGraph(data.cameras)
        assert jax_runner.run_optimization(
            data, jax_pg, visual_frontend=_jax_frontend(jax_runner, config, data))
    finally:
        lm_fused.solve_two_phase_fused = fused
    return dict(data=data, runner=jax_runner, pg=jax_pg, records=recorder.records)


def test_f32_session_against_jax_f32(jax_f32_session):
    """The 8-frame session at f32 through the JAX runner and the port (on
    the CPU), beside the port's f64 run: the same solve schedule,
    trajectories equal to f32 accuracy, and both f32 runs taking more LM
    iterations than the f64 run. Their per-solve LM iteration counts differ;
    test_f32_solves_part_only_on_roundoff shows why."""
    data, jax_runner, jax_pg = (jax_f32_session[k] for k in ("data", "runner", "pg"))
    runs = {}
    for dtype in (np.float32, np.float64):
        ours_data, _, _ = ot.synthetic_session(**SESSION)
        runner = ot.OfflineProblemRunner(small_config(ot.config), dtype=dtype, device="cpu")
        pg = ot.PoseGraph(ours_data.cameras)
        assert runner.run_optimization(
            ours_data, pg, visual_frontend=prunner.visual_frontend_for(runner, ours_data))
        runs[dtype] = (runner, pg)
    ours, ref = runs[np.float32][0].opt_log, jax_runner.opt_log
    assert [(r.frame_id, r.phase, r.attempt) for r in ours] == [
        (r.frame_id, r.phase, r.attempt) for r in ref]
    n = data.max_frame_id() + 1
    np.testing.assert_allclose(_trajectory(runs[np.float32][1], n), _trajectory(jax_pg, n),
                               rtol=0, atol=1e-3)
    iters = {name: sum(r.iterations for r in log) for name, log in (
        ("jax f32", ref), ("port f32", ours), ("port f64", runs[np.float64][0].opt_log))}
    assert min(iters["jax f32"], iters["port f32"]) > iters["port f64"], iters


# An LM step whose cost decrease is at least this share of the cost is
# resolved in f32 (~800 ulps of the cost); below it, whether the step is
# accepted, and how the trust region moves, rides on the cost's roundoff.
RESOLVED_DECREASE = 1e-4
# A window that starts at its optimum (the first frame's) has a cost of
# f32 roundoff alone (~1e-14): costs are compared to this much absolutely.
COST_ATOL = 1e-9
# Costs after the same resolved steps: the f32 solve of each step rounds
# differently in the two packages, and the cost's fall (from hundreds to
# ~20) grows that (up to 1.1e-4 relative on this session).
STEP_COST_RTOL = 5e-4


def test_f32_solves_part_only_on_roundoff(jax_f32_session):
    """Every f32 solve of the JAX session, replayed through the port's f32
    solver on the JAX solve's own inputs: the two LM loops take the same
    steps (accepted, same trust radius, costs within STEP_COST_RTOL) for as long as
    each step's cost decrease is resolved in f32, and part only at the first
    step where either decrease is not; they start and end at costs within
    1e-5 (f32 sums of the same terms in other orders). So the
    per-solve iteration counts of two f32 sessions differ where the last
    steps' cost changes are within f32 roundoff, and either package may take
    the longer tail."""
    from torch_object_helpers import replay

    records = jax_f32_session["records"]
    assert [r[0] for r in records] == ["two_phase"] * len(records) and records
    parted, longer = 0, set()
    for i, record in enumerate(records):
        _, summaries = replay(record)
        for phase, (ours, ref) in enumerate(zip(summaries, record[2][1:]), start=1):
            where = f"solve {i} phase {phase}"
            assert len(ours.iterations) == ours.num_iterations and (
                len(ref.iterations) == ref.num_iterations), where
            np.testing.assert_allclose(ours.initial_cost, ref.initial_cost, rtol=1e-5,
                                       atol=COST_ATOL, err_msg=where)
            for a, b in zip(ours.iterations, ref.iterations):
                resolved = [it.accepted and it.cost_change >= RESOLVED_DECREASE * it.cost
                            for it in (a, b)]
                if not all(resolved):
                    break
                np.testing.assert_allclose(a.cost, b.cost, rtol=STEP_COST_RTOL, atol=COST_ATOL,
                                           err_msg=where)
                np.testing.assert_allclose(a.radius, b.radius, rtol=1e-6, err_msg=where)
            else:
                assert ours.num_iterations == ref.num_iterations, where
            np.testing.assert_allclose(ours.final_cost, ref.final_cost, rtol=1e-5,
                                       atol=COST_ATOL, err_msg=where)
            if ours.num_iterations != ref.num_iterations:
                parted += 1
                longer.add("port" if ours.num_iterations > ref.num_iterations else "jax")
    assert parted and longer == {"port", "jax"}, (parted, longer)
