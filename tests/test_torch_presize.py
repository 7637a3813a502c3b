"""The session capacity presizing and the mini-BA's capacity buckets of
obvi_slam_tpu_torch against the JAX package at f64 on CPU: the raw-count
seeds of a frame range and the five seeded pools equal the JAX runner's key
by key (a visual session, an object session with bounding boxes, and a
130-frame session whose 256-pose cap engages the band layout's seeds); the
port's session presized, unpresized and under-seeded ends at roundoff of
itself (tests/test_runner_e2e.py::TestCapsPresize's counterpart); and a
padded mini-BA equals the unpadded one."""

import copy

import numpy as np
import pytest
import torch

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import runner as jrunner
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf
from obvi_slam_tpu_torch.offline_data import OfflineProblemData
from obvi_slam_tpu_torch.pose_graph import CameraInfo
from obvi_slam_tpu_torch.runner import visual_frontend_for
from obvi_slam_tpu_torch.solver.plan import BAND_TP
from test_torch_objects import _pending_set
from test_torch_runner import small_config
from torch_object_helpers import ASYM_DIMS, object_config, port_frontend, to_jax_data

torch.set_num_threads(1)


def long_session(n_frames=130, n_features=400, seed=5):
    """Counting data only (no solve reads it): stereo tracks of 2-30
    consecutive frames, so that every track stays within its 64-pose band
    group's 128-pose window."""
    rng = np.random.default_rng(seed)
    k = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    cameras = {1: CameraInfo(k, np.eye(3), np.zeros(3)),
               2: CameraInfo(k, np.eye(3), np.array([0.12, 0.0, 0.0]))}
    tracks = {}
    for j in range(n_features):
        first = int(rng.integers(0, n_frames - 2))
        last = min(n_frames - 1, first + int(rng.integers(1, 30)))
        tracks[j] = {f: {c: rng.uniform(0, 480, 2) for c in cameras if rng.random() < 0.8
                         or c == 1} for f in range(first, last + 1)}
    poses = {f: np.array([0.25 * f, 0, 0, 0, 0, 0.0]) for f in range(n_frames)}
    return OfflineProblemData(cameras=cameras, feature_tracks=tracks,
                              feature_init_positions={j: np.zeros(3) for j in tracks},
                              initial_poses=poses)


def pgo_config(module, dims=None):
    """The object test config with PGO on global and final BA, so that the
    pgo, pgo_vf and pgo_tracking pools are seeded too."""
    c = object_config(module) if dims is None else object_config(module, dims)
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = True
    en.use_pose_graph_on_final_global_ba = True
    en.poses_prior_to_window_to_keep_constant = 3
    return c


DATASETS = {
    "visual": lambda: ot.synthetic_session(n_frames=12, n_features=40)[0],
    "objects": lambda: ot.synthetic_object_session(n_frames=14, n_objects=4, n_features=60,
                                                   baseline=0.12, dims=ASYM_DIMS)[0],
    "long_130": long_session,
}
RANGES = {
    "visual": [(0, 11), (0, 6), (4, 10), (11, 11)],
    "objects": [(0, 13), (0, 6), (5, 13), (3, 3)],
    "long_130": [(0, 129), (0, 63), (40, 129), (100, 110)],
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def dataset(request):
    data = DATASETS[request.param]()
    return request.param, data, to_jax_data(data)


def _runners(config_of):
    return (ot.OfflineProblemRunner(config_of(pcfg), device="cpu"),
            jrunner.OfflineProblemRunner(config_of(jcfg), use_device_sync=False))


def test_window_caps_seed_equals_jax(dataset):
    name, data, jdata = dataset
    ours, ref = _runners(pgo_config)
    for lo, hi in RANGES[name]:
        seed = ours._window_caps_seed(data, lo, hi)
        assert seed == ref._window_caps_seed(jdata, lo, hi), (name, lo, hi)
    if name == "objects":
        assert ours._window_caps_seed(data, 0, 13)["ob_pair"] > 64
    if name == "long_130":
        seed = ours._window_caps_seed(data, 0, 129)
        assert seed["n_pose"] == 256 >= 3 * BAND_TP
        assert seed["pt_band_lg"] > 0 and seed["rel_band_lg"] == 128


def test_presized_pools_equal_jax(dataset):
    """All five pools after presize_session_caps with PGO on global BA."""
    _, data, jdata = dataset
    ours, ref = _runners(pgo_config)
    assert ours.presize_session_caps(data) == ref.presize_session_caps(jdata)
    assert sorted(ours._caps_pools) == ["global", "local", "pgo", "pgo_tracking", "pgo_vf"]
    horizon = data.max_frame_id() - 2
    ours, ref = _runners(pgo_config)
    assert ours.presize_session_caps(data, horizon) == ref.presize_session_caps(jdata, horizon)


def test_without_pgo_seeds_local_and_global():
    data = DATASETS["visual"]()
    ours, ref = _runners(small_config)
    pools = ours.presize_session_caps(data)
    assert sorted(pools) == ["global", "local"]
    assert pools == ref.presize_session_caps(to_jax_data(data))


class TestCapsPresize:
    """The port's counterpart of tests/test_runner_e2e.py::TestCapsPresize:
    padding rows are masked everywhere, so a session at larger capacities
    is the same computation up to roundoff."""

    @staticmethod
    def _run(data, mode):
        runner = ot.OfflineProblemRunner(small_config(pcfg), device="cpu")
        if mode == "off":
            runner.presize_session_caps = lambda *a, **k: runner._caps_pools
        elif mode == "tiny":
            # Horizon 3 of a 12-frame session: later windows outgrow it.
            def tiny(d, max_frame_id=None, n_ltm=0):
                runner._seed_pool("local", runner._window_caps_seed(d, 0, 3))
                runner._seed_pool("global", runner._window_caps_seed(d, 0, 3))
                return runner._caps_pools

            runner.presize_session_caps = tiny
        pg = ot.PoseGraph(data.cameras)
        shapes = []
        build = runner._build_problem

        def record(pg_, scope, key, **kw):
            problem = build(pg_, scope, key, **kw)
            shapes.append((key, problem.state.poses.shape[0], problem.tables.reproj.capacity))
            return problem

        runner._build_problem = record
        assert runner.run_optimization(data, pg, visual_frontend=visual_frontend_for(runner, data))
        est = np.stack([pg.get_robot_pose(i) for i in range(data.max_frame_id() + 1)])
        return est, runner, shapes

    @pytest.fixture(scope="class")
    def sessions(self):
        data, _, _ = ot.synthetic_session()
        return data, {mode: self._run(data, mode) for mode in ("normal", "off", "tiny")}

    @pytest.fixture(scope="class")
    def jax_session(self, sessions):
        """The JAX runner, presizing, on the same session (its host loop,
        the CPU's default, without device sync)."""
        from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
        from test_torch_runner import _jax_frontend

        data = to_jax_data(sessions[0])
        config = small_config(jcfg)
        runner = jrunner.OfflineProblemRunner(config, use_device_sync=False)
        pg = JaxPoseGraph(data.cameras)
        assert runner.run_optimization(data, pg,
                                       visual_frontend=_jax_frontend(runner, config, data))
        est = np.stack([pg.get_robot_pose(i) for i in range(data.max_frame_id() + 1)])
        return est, runner

    def test_presized_matches_unpresized(self, sessions):
        _, runs = sessions
        np.testing.assert_allclose(runs["normal"][0], runs["off"][0], rtol=1e-10, atol=1e-12)
        # Presized, each family keeps one shape; unpresized, the windows grow.
        for key in ("local", "global"):
            assert len({s[1:] for s in runs["normal"][2] if s[0] == key}) == 1, key
        assert len({s[1:] for s in runs["off"][2]}) > 2

    def test_seed_exceeded_growth_path_matches(self, sessions):
        data, runs = sessions
        _, runner, _ = runs["tiny"]
        seed = runner._window_caps_seed(data, 0, 3)
        grew = [k for k, v in seed.items() if runner.caps_pool("global").get(k, 0) > v]
        assert grew, "expected the session to outgrow the horizon-3 seed"
        np.testing.assert_allclose(runs["tiny"][0], runs["normal"][0], rtol=1e-10, atol=1e-12)

    def test_presized_pools_equal_jax_runners(self, sessions, jax_session):
        """The port's pools at the end of the session equal the JAX
        runner's seeds on the same data (no window outgrew them) and its
        pools at the end of its own presized session; the two presized
        sessions end together (tests/test_torch_runner.py's tolerance)."""
        data, runs = sessions
        est, runner = jax_session
        ref = jrunner.OfflineProblemRunner(small_config(jcfg), use_device_sync=False)
        assert runs["normal"][1]._caps_pools == ref.presize_session_caps(to_jax_data(data))
        assert runs["normal"][1]._caps_pools == runner._caps_pools
        np.testing.assert_allclose(runs["normal"][0], est, rtol=1e-6, atol=1e-9)


def _port_pending_set():
    """The port's frontend holding the pending set of
    test_torch_objects._pending_set on ground-truth poses, and the indices
    of the pending objects with an estimate."""
    data, gt_poses, _, ref = _pending_set()
    pg = ot.PoseGraph(data.cameras, pcfg.shape_prior_map(object_config(pcfg)))
    for i in range(len(gt_poses)):
        pg.add_frame(i, gt_poses[i])
    fe = port_frontend(pg, object_config(pcfg))
    for p in ref.pending:
        fe.pending.append(bbf.PendingObject(
            p.semantic_class, p.min_frame_id, p.max_frame_id,
            [bbf.PendingObservation(o.frame_id, o.camera_id, o.corners, o.covariance,
                                    o.confidence) for o in p.observations],
            p.observed_feats, None if p.object_estimate is None else p.object_estimate.copy(),
            p.max_confidence, p.ready_for_merge,
        ))
    return fe, [i for i, p in enumerate(fe.pending) if p.object_estimate is not None]


def test_padded_mini_ba_equals_unpadded(monkeypatch):
    fe, targets = _port_pending_set()
    assert len(targets) >= 2
    start = [fe.pending[i].object_estimate.copy() for i in targets]
    unpadded = copy.deepcopy(fe)
    sizes = []
    solve = bbf.solve

    def spy(state, cams, tables, plan, free, **kw):
        sizes.append((state.poses.shape[0], state.objects.shape[0], tables.bbox.capacity,
                      int(free.objects.sum())))
        return solve(state, cams, tables, plan, free, **kw)

    monkeypatch.setattr(bbf, "solve", spy)
    fe._run_pending_mini_ba(targets)
    with monkeypatch.context() as m:
        # At the pending set's own sizes, as before the buckets.
        m.setattr(bbf, "_bucket", lambda n, minimum=16: max(n, 1))
        unpadded._run_pending_mini_ba(targets)
    n_frames = len({o.frame_id for i in targets for o in fe.pending[i].observations})
    n_obs = sum(len(fe.pending[i].observations) for i in targets)
    assert sizes[1] == (n_frames, len(targets), n_obs, len(targets))
    assert sizes[0] == (max(8, n_frames), 4, 16, len(targets)) != sizes[1]
    assert fe._mini_ba_caps["n_pose"] == 8 and unpadded._mini_ba_caps["n_pose"] == n_frames
    for i, s in zip(targets, start):
        assert np.abs(fe.pending[i].object_estimate - s).max() > 1e-3
        np.testing.assert_allclose(fe.pending[i].object_estimate,
                                   unpadded.pending[i].object_estimate, rtol=1e-10, atol=1e-12)


def test_mini_ba_caps_grow_monotonically():
    """A smaller pending set after a larger one runs at the larger caps."""
    fe, targets = _port_pending_set()
    fe._run_pending_mini_ba(targets)
    big = dict(fe._mini_ba_caps)
    fe._run_pending_mini_ba(targets[:1])
    assert fe._mini_ba_caps == big
    assert set(big) == {"n_pose", "n_obj", "bbox", "shape", *bbf.OB_PLAN_CAP_KEYS}


def test_rectify_matches_jax():
    from obvi_slam_tpu import geometry as jgeo
    from obvi_slam_tpu import types as jtypes
    from obvi_slam_tpu_torch import geometry as geo

    rng = np.random.default_rng(3)
    pix, corners = rng.uniform(0, 640, (5, 7, 2)), rng.uniform(0, 640, (9, 4))
    f = rng.uniform(400, 600, (4,))
    c = rng.uniform(200, 300, (4,))
    np.testing.assert_allclose(
        geo.rectify_pixel(torch.from_numpy(pix), *map(torch.tensor, (f[0], f[1], c[0], c[1]))),
        np.asarray(jgeo.rectify_pixel(pix, f[0], f[1], c[0], c[1])), rtol=1e-15, atol=0)
    np.testing.assert_allclose(
        geo.rectify_bb_corners(torch.from_numpy(corners),
                               *map(torch.tensor, (f[2], f[3], c[2], c[3]))),
        np.asarray(jgeo.rectify_bb_corners(corners, f[2], f[3], c[2], c[3])), rtol=1e-15, atol=0)
    for name in ("POSE_DIM", "POINT_DIM", "ELLIPSOID_DIM"):
        assert getattr(ot.types, name) == getattr(jtypes, name)
