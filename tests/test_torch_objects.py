"""The port's object pipeline against the JAX package at f64 on CPU: the
synthetic object session, the bounding-box frontend (association, filtering,
merges), the pending-object mini-BA alone, and a whole object session through
both runners (solve records, trajectory, ellipsoids)."""

import dataclasses

import numpy as np
import pytest
import torch

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu.frontend import apply_merges as jax_apply_merges
from obvi_slam_tpu.frontend import make_bb_frontend_hook as jax_bb_hook
from obvi_slam_tpu.frontend import merge_objects_by_center_proximity as jax_merges
from obvi_slam_tpu.offline_data import RawBoundingBox as JaxBox
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.solver import problem as jproblem
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch import frontend as pfrontend
from obvi_slam_tpu_torch import ops
from obvi_slam_tpu_torch.offline_data import RawBoundingBox
from obvi_slam_tpu_torch.solver import problem as pproblem
from test_torch_runner import _assert_trees_equal
from test_bb_frontend import make_object_session
from torch_object_helpers import (
    assert_replays_match,
    assert_same_objects,
    assert_same_schedule,
    jax_frontend,
    jax_fused_mini_ba,
    ASYM_DIMS,
    object_config,
    port_frontend,
    run_jax_session,
    run_port_session,
    to_jax_data,
    trajectory,
)

torch.set_num_threads(1)


def test_synthetic_object_session_equals_make_object_session():
    data, gt_poses, gt_objects = ot.synthetic_object_session()
    ref, ref_poses, ref_objects = make_object_session()
    np.testing.assert_array_equal(gt_poses, ref_poses)
    np.testing.assert_array_equal(gt_objects, ref_objects)
    assert data.cameras.keys() == ref.cameras.keys()
    assert data.feature_tracks.keys() == ref.feature_tracks.keys()
    for j, track in data.feature_tracks.items():
        assert track.keys() == ref.feature_tracks[j].keys()
        for i, obs in track.items():
            assert obs.keys() == ref.feature_tracks[j][i].keys()
            for cam, px in obs.items():
                np.testing.assert_array_equal(px, ref.feature_tracks[j][i][cam])
    assert data.bounding_boxes.keys() == ref.bounding_boxes.keys()
    for i, by_cam in data.bounding_boxes.items():
        assert by_cam.keys() == ref.bounding_boxes[i].keys()
        for cam, bbs in by_cam.items():
            theirs = ref.bounding_boxes[i][cam]
            assert len(bbs) == len(theirs)
            for a, b in zip(bbs, theirs):
                np.testing.assert_array_equal(a.corners, b.corners)
                assert (a.semantic_class, a.detection_confidence) == (
                    b.semantic_class, b.detection_confidence)
    for name in ("feature_init_positions", "initial_poses"):
        ours, theirs = getattr(data, name), getattr(ref, name)
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])


def _assert_same_frontend(fe, ref, rtol=1e-8):
    """Equal pending objects (observations, contexts, estimates, flags) and
    appearance maps."""
    assert len(fe.pending) == len(ref.pending)
    for a, b in zip(fe.pending, ref.pending):
        assert (a.semantic_class, a.min_frame_id, a.max_frame_id, a.max_confidence,
                a.ready_for_merge) == (b.semantic_class, b.min_frame_id, b.max_frame_id,
                                       b.max_confidence, b.ready_for_merge)
        assert a.observed_feats == b.observed_feats
        assert len(a.observations) == len(b.observations)
        for oa, ob in zip(a.observations, b.observations):
            assert (oa.frame_id, oa.camera_id, oa.confidence) == (
                ob.frame_id, ob.camera_id, ob.confidence)
            np.testing.assert_array_equal(oa.corners, ob.corners)
            np.testing.assert_array_equal(oa.covariance, ob.covariance)
        if b.object_estimate is None:
            assert a.object_estimate is None
        else:
            np.testing.assert_allclose(a.object_estimate, b.object_estimate, rtol=rtol,
                                       atol=1e-12)
    assert fe.object_appearance == ref.object_appearance


def _gt_pose_graphs(data, gt_poses, config):
    jpg = JaxPoseGraph(data.cameras, jcfg.shape_prior_map(config))
    pg = ot.PoseGraph(data.cameras, pcfg.shape_prior_map(object_config(pcfg)))
    for i in range(len(gt_poses)):
        jpg.add_frame(i, gt_poses[i])
        pg.add_frame(i, gt_poses[i])
    return jpg, pg


class TestFrontendAgainstJax:
    """tests/test_bb_frontend.py's association, filtering and merge cases,
    each compared with the JAX frontend's state."""

    def test_association_on_ground_truth_poses(self):
        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        jpg, pg = _gt_pose_graphs(data, gt_poses, config)
        ref = jax_frontend(jpg, config)
        fe = port_frontend(pg, object_config(pcfg))
        jhook, hook = jax_bb_hook(ref), pfrontend.make_bb_frontend_hook(fe)
        with jax_fused_mini_ba():
            for i in range(len(gt_poses)):
                jhook(data, jpg, i)
                hook(data, pg, i)
                _assert_same_frontend(fe, ref)
                assert_same_objects(pg, jpg, rtol=1e-8, atol=1e-12)
        # The reference test's gates: two objects near the ground truth.
        assert len(pg.objects) == 2
        for node in pg.objects.values():
            assert min(np.linalg.norm(node.ellipsoid[:3] - g[:3]) for g in gt_objects) < 1.0
        assert sum(len(v) for v in pg.obj_obs_by_object.values()) >= 16

    def test_low_confidence_filtered(self):
        data, gt_poses, _ = make_object_session()
        for module, box, graph, make in (
            (jcfg, JaxBox, JaxPoseGraph, jax_frontend),
            (pcfg, RawBoundingBox, ot.PoseGraph, port_frontend),
        ):
            pg = graph(data.cameras, {})
            pg.add_frame(0, gt_poses[0])
            fe = make(pg, object_config(module))
            fe.add_bounding_box_observations(
                0, 1, [box(np.array([100.0, 200, 100, 200]), "chair", 0.05)], {}
            )
            assert len(fe.pending) == 0 and len(pg.objects) == 0

    @pytest.mark.parametrize("case", ["center_proximity", "ltm_survives"])
    def test_merges_match_jax(self, case):
        results = []
        for graph, merges, apply in (
            (JaxPoseGraph, jax_merges, jax_apply_merges),
            (ot.PoseGraph, pfrontend.merge_objects_by_center_proximity, pfrontend.apply_merges),
        ):
            pg = graph({}, {})
            if case == "center_proximity":
                a = pg.add_new_ellipsoid([0, 0, 5, 0, 1, 1, 1], "chair")
                b = pg.add_new_ellipsoid([0.5, 0.1, 5.2, 0, 1, 1, 1], "chair")
                pg.add_new_ellipsoid([10, 0, 5, 0, 1, 1, 1], "chair")
                pg.add_new_ellipsoid([0.2, 0, 5.1, 0, 1, 1, 1], "bench")
                pg.add_object_observation(a, 0, 1, np.zeros(4), np.eye(4))
                pg.add_object_observation(b, 1, 1, np.zeros(4), np.eye(4))
            else:
                pg.add_ltm_object(7, [0, 0, 5, 0, 1, 1, 1], "chair")
                b = pg.add_new_ellipsoid([0.3, 0, 5, 0, 1, 1, 1], "chair")
            found = merges(pg, 2.0, x_y_only=True)
            assert apply(pg, found)
            results.append((found, sorted(pg.objects), dict(pg.merged_objects),
                            {o: list(v) for o, v in pg.obj_obs_by_object.items()}))
        assert results[0] == results[1]
        if case == "ltm_survives":
            assert results[1][0] == {7: {b}} and 7 in results[1][1]


def _pending_set(seed=21, n_frames=4):
    """A frontend's pending set, mid-session, from the JAX frontend on
    ground-truth poses (its mini-BA off), and the pose graph it belongs to."""
    data, gt_poses, _ = make_object_session(n_frames=n_frames, seed=seed)
    config = object_config()
    jpg, _ = _gt_pose_graphs(data, gt_poses, config)
    fe = jax_frontend(jpg, config)
    fe._run_pending_mini_ba = lambda targets: None
    hook = jax_bb_hook(fe)
    for i in range(n_frames):
        hook(data, jpg, i)
    return data, gt_poses, config, fe


def test_mini_ba_alone_matches_jax(monkeypatch):
    """The same pending set through both mini-BAs: a problem of bounding-box
    and shape-prior factors only, no reprojection rows. K1 meets its empty
    table (one row, none live) and K2 the mini-BA's table."""
    data, gt_poses, config, ref = _pending_set()
    targets = [i for i, p in enumerate(ref.pending) if p.object_estimate is not None]
    assert len(targets) >= 2

    pg = ot.PoseGraph(data.cameras, pcfg.shape_prior_map(object_config(pcfg)))
    for i in range(len(gt_poses)):
        pg.add_frame(i, gt_poses[i])
    fe = port_frontend(pg, object_config(pcfg))
    for p in ref.pending:
        fe.pending.append(pfrontend.bounding_box_frontend.PendingObject(
            p.semantic_class, p.min_frame_id, p.max_frame_id,
            [pfrontend.bounding_box_frontend.PendingObservation(
                o.frame_id, o.camera_id, o.corners, o.covariance, o.confidence)
             for o in p.observations],
            p.observed_feats, None if p.object_estimate is None else p.object_estimate.copy(),
            p.max_confidence, p.ready_for_merge,
        ))
    seen = {}

    def spy(name, fn):
        def wrapped(state, cams, f, *a):
            seen.setdefault(name, []).append(
                (f.mask.shape[0], int(f.mask.sum()), state.points.shape[0]))
            return fn(state, cams, f, *a)
        monkeypatch.setattr(ops, name, wrapped)

    spy("reproj_residuals_and_jac", ops.reproj_residuals_and_jac)
    spy("bbox_residuals_and_jac", ops.bbox_residuals_and_jac)

    start = [p.object_estimate.copy() for p in ref.pending if p.object_estimate is not None]
    del ref._run_pending_mini_ba
    with jax_fused_mini_ba():
        ref._run_pending_mini_ba(targets)
    fe._run_pending_mini_ba(targets)
    for i in targets:
        np.testing.assert_allclose(fe.pending[i].object_estimate, ref.pending[i].object_estimate,
                                   rtol=1e-8, atol=1e-12)
    assert any(np.abs(a - fe.pending[i].object_estimate).max() > 1e-3
               for a, i in zip(start, targets))
    n_obs = sum(len(fe.pending[i].observations) for i in targets)
    assert seen["reproj_residuals_and_jac"] and all(
        s == (1, 0, 1) for s in seen["reproj_residuals_and_jac"])
    # The box table at its capacity bucket (16 and up), as the reference's.
    assert all(s[:2] == (pproblem._bucket(n_obs), n_obs) for s in seen["bbox_residuals_and_jac"])


class TestObjectSessionAgainstJax:
    """The 14-frame object session of make_object_session's draws, its
    chairs asymmetric, through both runners (see torch_object_helpers for
    why each JAX solve is replayed)."""

    @pytest.fixture(scope="class")
    def sessions(self):
        data, gt_poses, gt_objects = ot.synthetic_object_session(dims=ASYM_DIMS)
        jax_runner, jax_pg, jax_fe, recorder = run_jax_session(
            to_jax_data(data), object_config(dims=ASYM_DIMS))
        runner, pg, fe = run_port_session(data, object_config(pcfg, ASYM_DIMS))
        return dict(data=data, gt=gt_poses, gt_objects=gt_objects, jax_runner=jax_runner,
                    jax_pg=jax_pg, records=recorder.records, builds=recorder.builds,
                    runner=runner, pg=pg, jax_fe=jax_fe, fe=fe)

    def test_presized_caps_equal_jax(self, sessions):
        """Both runners presize: the session's caps pools and, after the
        chained session, the mini-BA's bucketed caps equal the JAX ones."""
        assert sessions["runner"]._caps_pools == sessions["jax_runner"]._caps_pools
        caps = sessions["fe"]._mini_ba_caps
        assert caps == sessions["jax_fe"]._mini_ba_caps
        assert caps["n_pose"] >= 8 and caps["n_obj"] >= 4 and caps["bbox"] >= 16

    @pytest.mark.parametrize("which", ["first object window", "sliding window with objects"])
    def test_window_problem_equals_jax(self, sessions, which):
        """The first window problem with bounding-box factors, and the last
        sliding-window (two-phase) problem with them, built by the port from
        the JAX runner's pose graph at the JAX runner's caps: equal tables,
        plan, weights and state, as tests/test_torch_runner.py holds the
        visual-only windows."""
        with_objects = [b for b in sessions["builds"]
                        if b[2] in ("local", "global") and not b[4]
                        and int(np.asarray(b[5].tables.bbox.mask).sum())]
        if which == "first object window":
            build = with_objects[0]
        else:
            build = [b for b in with_objects if b[2] == "local" and b[1].min_frame_id > 0][-1]
        state, scope, key, pool, _, ref = build
        data, config = sessions["data"], sessions["runner"].config
        pg = ot.PoseGraph.from_state(
            state, {c: ot.pose_graph.CameraInfo(**dataclasses.asdict(v))
                    for c, v in data.cameras.items()}, pcfg.shape_prior_map(config))
        ours = pproblem.build_problem(
            pg, pproblem.Scope(**dataclasses.asdict(scope)),
            config.object_visual_pose_graph_residual_params,
            dtype=np.float64, caps=pool, device="cpu",
        )
        assert int(ours.tables.bbox.mask.sum()) == int(np.asarray(ref.tables.bbox.mask).sum()) > 0
        assert pproblem.observed_caps(ours) == jproblem.observed_caps(ref)
        for name in ("state", "cams", "tables", "plan", "free", "weights", "aux", "huber"):
            _assert_trees_equal(getattr(ours, name), getattr(ref, name), name)
        for name in ("pose_rows", "point_rows", "obj_rows", "reproj_rows", "bbox_rows",
                     "relpose_rows", "shape_rows", "ltm_rows"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), name)
        for k, v in ref.base_weights_np.items():
            np.testing.assert_array_equal(ours.base_weights_np[k], v, k)

    def test_every_solve_replays_equal(self, sessions):
        """Window BAs (two-phase, with K1 and K2's plain versions on object
        tables) and pending-object mini-BAs."""
        kinds = {r[0] for r in sessions["records"]}
        assert kinds == {"solve", "two_phase"}
        assert_replays_match(sessions["records"])

    def test_same_schedule_and_associations(self, sessions):
        assert_same_schedule(sessions["runner"].opt_log, sessions["jax_runner"].opt_log)
        assert {r.phase for r in sessions["runner"].opt_log} == {1, 2}
        assert_same_objects(sessions["pg"], sessions["jax_pg"], values=False)
        assert sessions["pg"].merged_objects == sessions["jax_pg"].merged_objects

    def test_meets_the_reference_gates(self, sessions):
        """tests/test_bb_frontend.py::test_full_object_visual_run's gates."""
        gt_objects, gt = sessions["gt_objects"], sessions["gt"]
        for pg in (sessions["pg"], sessions["jax_pg"]):
            assert len(pg.objects) == 2
            for node in pg.objects.values():
                assert min(np.linalg.norm(node.ellipsoid[:3] - g[:3]) for g in gt_objects) < 0.5
            n = len(gt)
            ate = np.sqrt(np.mean(np.sum((trajectory(pg, n)[:, :3] - gt[:, :3]) ** 2, 1)))
            assert ate < 0.05


class TestRoshanAgainstJax:
    """tests/test_roshan_frontend.py's cases through both packages' Roshan
    (hue-saturation histogram) frontends, on ground-truth poses."""

    @pytest.mark.parametrize("case", ["identical", "different_hues", "empty"])
    def test_histograms_match_jax(self, case):
        from obvi_slam_tpu.frontend import roshan_frontend as jr
        from obvi_slam_tpu_torch.frontend import roshan_frontend as pr

        rng = np.random.default_rng(0)
        if case == "identical":
            a = b = rng.uniform(0, 180, (20, 20, 3))
        elif case == "different_hues":
            a, b = np.zeros((20, 20, 3)), np.zeros((20, 20, 3))
            a[..., :2], b[..., :2] = (5, 200), (120, 200)
        else:
            a = b = np.zeros((0, 0, 3))
        hists = [(m.hue_sat_histogram(a), m.hue_sat_histogram(b)) for m in (jr, pr)]
        if case == "empty":
            assert all(h is None for pair in hists for h in pair)
            assert pr.histogram_correlation(None, None) == 0.0
            return
        np.testing.assert_array_equal(hists[1][0], hists[0][0])
        corr = [m.histogram_correlation(*h) for m, h in zip((jr, pr), hists)]
        assert corr[0] == corr[1]
        assert abs(corr[1] - 1.0) < 1e-12 if case == "identical" else corr[1] < 0.1

    @pytest.mark.parametrize("with_images", [True, False])
    def test_association_matches_jax(self, with_images):
        from obvi_slam_tpu.frontend.roshan_frontend import RoshanBbFrontEnd as JaxRoshan
        from test_roshan_frontend import synthetic_hsv_provider

        n_frames, seed = (12, 61) if with_images else (10, 62)
        data, gt_poses, gt_objects = make_object_session(n_frames=n_frames, seed=seed)
        params = {"min_observations": 5, "min_observations_for_local_est": 3}
        if with_images:
            params.update(max_distance_for_associated_ellipsoids=3.5, min_bb_confidence=0.3,
                          required_min_conf_for_initialization=0.5)
        provider = synthetic_hsv_provider(data, gt_objects) if with_images else None
        config = object_config()
        jpg, pg = _gt_pose_graphs(data, gt_poses, config)
        fes = []
        for cls, graph, module, kw in ((JaxRoshan, jpg, jcfg, {}),
                                       (pfrontend.RoshanBbFrontEnd, pg, pcfg, {"device": "cpu"})):
            c = object_config(module)
            fe = cls(graph, params, c.bounding_box_covariance_generator_params,
                     c.geometric_similarity_scorer_params,
                     img_heights_and_widths={1: (480.0, 640.0)}, hsv_image_provider=provider,
                     **kw)
            fe.params.pending_obj_estimator_params.solver_params.max_num_iterations = 30
            fes.append(fe)
        ref, fe = fes
        with jax_fused_mini_ba():
            for i in range(n_frames):
                for f, graph in ((ref, jpg), (fe, pg)):
                    for cam_id, bbs in data.bounding_boxes.get(i, {}).items():
                        f.add_bounding_box_observations(i, cam_id, bbs, {})
                assert len(fe.pending) == len(ref.pending)
                for a, b in zip(fe.pending, ref.pending):
                    assert [(o.frame_id, o.camera_id) for o in a.observations] == [
                        (o.frame_id, o.camera_id) for o in b.observations]
                    if b.object_estimate is not None:
                        np.testing.assert_allclose(a.object_estimate, b.object_estimate,
                                                   rtol=1e-8, atol=1e-12)
                assert fe.object_appearance.keys() == ref.object_appearance.keys()
                assert_same_objects(pg, jpg, rtol=1e-8, atol=1e-12)
        if with_images:
            assert len(pg.objects) == 2
            for node in pg.objects.values():
                assert min(np.linalg.norm(node.ellipsoid[:3] - g[:3]) for g in gt_objects) < 1.0
            payload = fe.get_front_end_obj_map_data()
            assert any(i["histogram"] is not None for v in payload.values()
                       for i in v["infos_for_observed_bbs"])
        else:
            assert 1 <= len(pg.objects) <= 3
