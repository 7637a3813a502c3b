"""The port's host I/O against the JAX package's: readers (on sessions
written by ``synthetic.export_session_files``, and on vslam-set and TUM
fixtures written here), writers (byte for byte on one pose-graph state),
timestamped records (round trips, each package reading the other's files),
the optimization logger's CSVs, and the bounding-box retriever (the cases
of tests/test_bb_retriever.py against both packages)."""

import dataclasses
import stat
import sys
import textwrap

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from obvi_slam_tpu import io as jio
from obvi_slam_tpu import optlog as joptlog
from obvi_slam_tpu.frontend import bb_retriever as jretriever
from obvi_slam_tpu.io import readers as jreaders
from obvi_slam_tpu.io import timestamped as jts
from obvi_slam_tpu.io import writers as jwriters
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.solver.lm import IterationRecord as JaxRecord
from obvi_slam_tpu.solver.lm import LMSummary as JaxSummary
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import io as pio
from obvi_slam_tpu_torch import optlog as poptlog
from obvi_slam_tpu_torch.frontend import bb_retriever as pretriever
from obvi_slam_tpu_torch.io import readers as preaders
from obvi_slam_tpu_torch.io import timestamped as pts
from obvi_slam_tpu_torch.io import writers as pwriters
from obvi_slam_tpu_torch.solver.lm import IterationRecord, LMSummary
from obvi_slam_tpu_torch.synthetic import export_session_files
from torch_object_helpers import ASYM_DIMS


def assert_equal_tree(a, b, path="result"):
    """Equal structure and values: arrays by assert_array_equal, dataclasses
    (each package's own class) field by field."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(b):
            assert_equal_tree(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(b, dict):
        assert list(a.keys()) == list(b.keys()), path
        for k in b:
            assert_equal_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_tree(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


SESSIONS = {
    "visual": lambda: ot.synthetic_session(n_frames=8, n_features=30)[:2],
    "objects": lambda: ot.synthetic_object_session(n_frames=12, dims=ASYM_DIMS)[:2],
}


@pytest.fixture(scope="module", params=sorted(SESSIONS))
def exported(request, tmp_path_factory):
    data, gt = SESSIONS[request.param]()
    return data, export_session_files(data, gt, tmp_path_factory.mktemp(request.param))


@pytest.mark.parametrize("max_frame_id", [None, 5])
def test_readers_match_jax(exported, max_frame_id):
    """Both packages' readers on the same files: equal results (the port
    reads ORB tracks in Python, the reference through its native loader)."""
    data, d = exported
    for name, path in (("read_camera_intrinsics", "intrinsics.csv"),
                       ("read_camera_extrinsics", "extrinsics.csv"),
                       ("read_poses_by_node_id", "poses.csv"),
                       ("read_bounding_boxes_by_node_id", "bounding_boxes.csv")):
        assert_equal_tree(getattr(preaders, name)(str(d / path)),
                          getattr(jreaders, name)(str(d / path)), name)
    ours = preaders.read_orb_output_directory(str(d / "orb_out"), max_frame_id=max_frame_id)
    ref = jreaders.read_orb_output_directory(str(d / "orb_out"), max_frame_id=max_frame_id)
    assert_equal_tree(ours, ref, "orb")
    tracks = ours[0]
    assert tracks and all(len(t) >= 2 for t in tracks.values())
    if max_frame_id is not None:
        assert max(f for t in tracks.values() for f in t) <= max_frame_id
    else:
        assert tracks.keys() == data.feature_tracks.keys()
    n_cams = {len(c) for t in tracks.values() for c in t.values()}
    assert max(n_cams) == len(data.cameras)
    args = [preaders.read_camera_intrinsics(str(d / "intrinsics.csv")),
            preaders.read_camera_extrinsics(str(d / "extrinsics.csv"))]
    assert_equal_tree(preaders.make_cameras(*args), jreaders.make_cameras(*args), "cameras")
    cams, img_hw = preaders.make_cameras(*args)
    assert img_hw == {c: (480.0, 640.0) for c in data.cameras}
    for c, cam in data.cameras.items():
        np.testing.assert_allclose(cams[c].extrinsics_t, cam.extrinsics_t, atol=1e-15)


def test_export_equals_reference_test_writer(tmp_path):
    """A mono session: the same bytes as tests/test_cli.py::export_session."""
    from test_cli import export_session

    data, gt, _ = ot.synthetic_object_session(n_frames=6, seed=4)
    ours = export_session_files(data, gt, tmp_path / "ours")
    ref = export_session(data, gt, tmp_path / "ref")
    names = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def write_vslam_set(data, gt, d):
    """A vslam-set fixture of camera 1: per-frame files with the pose line
    and the feature pixels, the calibration and features files."""
    (d / "calibration").mkdir(parents=True)
    (d / "features").mkdir()
    (d / "calibration" / "camera_matrix.txt").write_text("500.0 500.0 320.0 240.0\n")
    with open(d / "features" / "features.txt", "w") as f:
        for j, p in sorted(data.feature_init_positions.items()):
            f.write(f"{j} {p[0]} {p[1]} {p[2]}\n")
    for i in range(len(gt)):
        q = Rotation.from_rotvec(gt[i, 3:]).as_quat()
        lines = [f"{i}", " ".join(str(v) for v in [*gt[i, :3], *q])]
        for j, cams in sorted(data.features_for_frame(i).items()):
            if 1 in cams:
                lines.append(f"{j} {cams[1][0]} {cams[1][1]}")
        (d / f"{i + 1:06d}.txt").write_text("\n".join(lines) + "\n")


def write_tum(data, gt, d):
    """A TUM consecutive-matching fixture: ``<N>_curr_<stamp>.txt`` files."""
    d.mkdir(parents=True)
    for i in range(len(gt)):
        q = Rotation.from_rotvec(gt[i, 3:]).as_quat()
        lines = [f"{i}", " ".join(str(v) for v in [*gt[i, :3], *q])]
        for j, cams in sorted(data.features_for_frame(i).items()):
            if 1 in cams:
                lines.append(f"{j} {cams[1][0]} {cams[1][1]}")
        (d / f"{i}_curr_{1305031100.25 + 0.5 * i}.txt").write_text("\n".join(lines) + "\n")


def test_fixture_readers_match_jax(tmp_path):
    data, gt, _ = ot.synthetic_session(n_frames=6, n_features=20)
    write_vslam_set(data, gt, tmp_path / "vslam")
    write_tum(data, gt, tmp_path / "tum")
    d = str(tmp_path / "vslam")
    for name in ("read_vslam_set", "read_vslam_set_calibration", "read_vslam_set_features"):
        assert_equal_tree(getattr(preaders, name)(d), getattr(jreaders, name)(d), name)
    poses, tracks = preaders.read_vslam_set(d)
    assert len(poses) == 6 and tracks
    for max_frames in (None, 4):
        ours = preaders.read_tum_consecutive_matching(str(tmp_path / "tum"), max_frames)
        ref = jreaders.read_tum_consecutive_matching(str(tmp_path / "tum"), max_frames)
        assert_equal_tree(ours, ref, f"tum {max_frames}")
        assert len(ours[0]) == (max_frames or 6)


def jax_pose_graph(data):
    """A JAX pose graph with frames, features, visual and odometry factors,
    three chairs (one merged away, so a merged id and a dropped shape prior
    are in its state) and their observations."""
    pg = JaxPoseGraph(data.cameras, {"chair": (np.array(ASYM_DIMS), np.eye(3) * 0.0025)})
    rng = np.random.default_rng(3)
    for i, pose in sorted(data.initial_poses.items()):
        pg.add_frame(i, pose)
        if i:
            pg.add_pose_factor(i - 1, i, pose - data.initial_poses[i - 1], np.eye(6) * 1e-4)
    for j, track in data.feature_tracks.items():
        pg.add_feature(j, data.feature_init_positions[j])
        for i, cams in track.items():
            for c, px in cams.items():
                pg.add_visual_factor(i, c, j, px, 1.0)
    ids = [pg.add_new_ellipsoid(
        np.concatenate([rng.normal(size=3) + [0, 0, 8], [rng.normal()], ASYM_DIMS]), "chair")
        for _ in range(3)]
    for frame, by_cam in data.bounding_boxes.items():
        for c, bbs in by_cam.items():
            for k, bb in enumerate(bbs):
                pg.add_object_observation(ids[(frame + k) % 3], frame, c, bb.corners,
                                          np.eye(4) * 4.0)
    pg.merge_objects(ids[2], ids[0])
    return pg


WRITERS = ("write_robot_pose_results", "write_ellipsoid_results",
           "write_visual_feature_results", "write_bb_association_results")


def test_writers_byte_equal_and_read_back(tmp_path):
    """PoseGraph.from_state of a JAX pose graph's state: the port's writers
    give the JAX writers' bytes; the read-back functions agree."""
    data, _, _ = ot.synthetic_object_session(n_frames=8, dims=ASYM_DIMS)
    jpg = jax_pose_graph(data)
    cams = {c: ot.pose_graph.CameraInfo(**dataclasses.asdict(v)) for c, v in data.cameras.items()}
    pg = ot.PoseGraph.from_state(jpg.get_state(), cams)
    assert pg.get_state() == jpg.get_state()
    for name in WRITERS:
        getattr(pwriters, name)(str(tmp_path / "ours" / name), pg)
        getattr(jwriters, name)(str(tmp_path / "ref" / name), jpg)
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    for reader, name in (("read_ellipsoid_results", "write_ellipsoid_results"),
                         ("read_bb_association_results", "write_bb_association_results")):
        path = str(tmp_path / "ours" / name)
        assert_equal_tree(getattr(pwriters, reader)(path), getattr(jwriters, reader)(path),
                          reader)
    ellipsoids, assoc = pio.read_bb_association_results(
        str(tmp_path / "ours" / "write_bb_association_results"))
    assert sorted(ellipsoids) == sorted(pg.objects) and sorted(assoc) == sorted(pg.objects)
    assert sorted(pts.read_robot_pose_results(
        str(tmp_path / "ours" / "write_robot_pose_results"))) == pg.frame_ids()
    assert jio.read_bb_association_results is jwriters.read_bb_association_results


def timestamped_entries(rng, n=5):
    stamps = [(1305031100 + i, int(rng.integers(0, 10**9))) for i in range(n)]
    poses = [np.concatenate([rng.normal(size=3), rng.normal(size=3) * 0.3]) for _ in range(n)]
    return stamps, poses


# (writer, reader, entries from (stamps, poses)).
TIMESTAMPED = {
    "poses": ("write_poses_with_timestamps", "read_poses_with_timestamps",
              lambda s, p: list(zip(s, p))),
    "optional_poses": ("write_optional_poses_with_timestamps",
                       "read_optional_poses_with_timestamps",
                       lambda s, p: [(t, None if i == 2 else x)
                                     for i, (t, x) in enumerate(zip(s, p))]),
    "node_ids": ("write_node_ids_and_timestamps", "read_node_ids_and_timestamps",
                 lambda s, p: [(3 * i, t) for i, t in enumerate(s)]),
    "timestamps": ("write_timestamps", "read_timestamps", lambda s, p: s),
    "waypoints": ("write_timestamps_and_waypoints", "read_timestamps_and_waypoints",
                  lambda s, p: [(t, i % 3, bool(i % 2)) for i, t in enumerate(s)]),
}


@pytest.mark.parametrize("kind", sorted(TIMESTAMPED))
def test_timestamped_round_trips_across_packages(tmp_path, kind):
    """Each package writes the same bytes, reads its own file back and reads
    the other's, with equal results."""
    writer, reader, make = TIMESTAMPED[kind]
    entries = make(*timestamped_entries(np.random.default_rng(11)))
    for name, mod in (("ours", pts), ("ref", jts)):
        getattr(mod, writer)(str(tmp_path / name / "f.csv"), entries)
    assert (tmp_path / "ours" / "f.csv").read_bytes() == (tmp_path / "ref" / "f.csv").read_bytes()
    back = {}
    for name, mod in (("ours", pts), ("ref", jts)):
        for other in ("ours", "ref"):
            back[name, other] = getattr(mod, reader)(str(tmp_path / other / "f.csv"))
    for key, value in back.items():
        assert_equal_tree(value, back["ref", "ref"], str(key))
    own = back["ours", "ours"]
    assert len(own) == len(entries)
    if kind in ("poses", "optional_poses"):
        for (t, x), (t0, x0) in zip(own, entries):
            assert t == t0 and (x is None) == (x0 is None)
            if x is not None:
                np.testing.assert_allclose(x, x0, rtol=1e-12, atol=1e-14)
    else:
        assert own == entries
    assert pts.timestamp_to_millis((12, 345678901)) == jts.timestamp_to_millis((12, 345678901))


def test_optlog_csvs_byte_equal(tmp_path):
    """Equal LM summaries through both packages' iteration loggers: the
    same ceres_iterations_<type>.csv bytes; nothing written when off."""
    rng = np.random.default_rng(2)
    runs = []
    for k in range(3):
        recs = [(i, float(rng.exponential() * 100), float(rng.normal()), float(rng.exponential()),
                 float(rng.exponential() * 1e4), bool(rng.integers(2)))
                for i in range(int(rng.integers(1, 6)))]
        runs.append((k, recs))
    for name, mod, record, summary in (("ours", poptlog, IterationRecord, LMSummary),
                                       ("ref", joptlog, JaxRecord, JaxSummary)):
        mod.IterationLoggerFactory.reset()
        ilf = mod.IterationLoggerFactory.instance()
        ilf.log_iterations(mod.PGO_TYPE, "0", summary(iterations=[record(*runs[0][1][0])]), 6)
        assert not ilf._buffers
        ilf.set_logging_directory(str(tmp_path / name))
        for k, recs in runs:
            s = summary(iterations=[record(*r) for r in recs])
            for t in (mod.PGO_TYPE, mod.LBA_PHASE1_TYPE, mod.PENDING_ESTIMATOR_TYPE):
                ilf.log_iterations(t, f"{k}_{t}", s, 7 * k)
        ilf.log_iterations(mod.VF_ADJUST_TYPE, "9", summary(), 3)
        ilf.write_all()
        mod.IterationLoggerFactory.reset()
    files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "ours").iterdir()) == [
        "ceres_iterations_lba_phase_1.csv", "ceres_iterations_pending_obj_est.csv",
        "ceres_iterations_pgo.csv"]
    for f in files:
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f


# ---- the bounding-box retriever: tests/test_bb_retriever.py's cases -------

RETRIEVERS = {"ours": pretriever, "ref": jretriever}

ECHO_WORKER = """
for line in sys.stdin:
    req = json.loads(line)
    dets = [
        {"label": "chair", "conf": 0.9, "xyxy": [10, 20, 110, 220]},
        {"label": "bench", "conf": 0.8, "xyxy": [-5, 20, 110, 220]},
        {"label": "couch", "conf": 0.7, "xyxy": [10, 20, 6000, 220]},
    ]
    print(json.dumps({"detections": dets}), flush=True)
"""

ONE_SHOT_WORKER = """
for line in sys.stdin:
    req = json.loads(line)
    print(json.dumps({"detections": [
        {"label": "chair", "conf": 0.5, "xyxy": [1, 2, 3, 4]}]}), flush=True)
    sys.exit(0)
"""


def write_worker(tmp_path, body):
    path = tmp_path / "fake_detector.py"
    path.write_text("#!/usr/bin/env python\nimport json, sys\n" + textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return [sys.executable, str(path)]


def provider(frame_id, camera_id):
    return f"/tmp/img_{frame_id}_{camera_id}.png", (480, 640)


def boxes(bbs):
    return [(b.corners.tolist(), b.semantic_class, b.detection_confidence) for b in bbs]


@pytest.mark.parametrize("case", ["validation", "multi_camera", "regeneration", "missing"])
def test_querier_matches_jax(tmp_path, case):
    """Each package's querier on the same worker: equal boxes (the corner
    validation drops two of three), per-camera queries, a worker that exits
    after each answer regenerated, and a missing image."""
    worker = write_worker(tmp_path, ONE_SHOT_WORKER if case == "regeneration" else ECHO_WORKER)
    results = {}
    for name, mod in RETRIEVERS.items():
        q = mod.SubprocessDetectorQuerier(
            worker, (lambda f, c: None) if case == "missing" else provider)
        try:
            if case == "validation":
                results[name] = boxes(q.retrieve_bounding_boxes_for_image(3, 1))
            elif case == "multi_camera":
                results[name] = {c: boxes(v) for c, v in q.retrieve_bounding_boxes(5, [1, 2]).items()}
            elif case == "regeneration":
                results[name] = [boxes(q.retrieve_bounding_boxes_for_image(0, 1))
                                 for _ in range(3)]
            else:
                results[name] = (q.retrieve_bounding_boxes_for_image(0, 1),
                                 q.retrieve_bounding_boxes(0, [1]))
        finally:
            q.close()
    assert results["ours"] == results["ref"]
    expected = {
        "validation": [([10.0, 110.0, 20.0, 220.0], "chair", 0.9)],
        "multi_camera": {c: [([10.0, 110.0, 20.0, 220.0], "chair", 0.9)] for c in (1, 2)},
        "regeneration": [[([1.0, 3.0, 2.0, 4.0], "chair", 0.5)]] * 3,
        "missing": (None, {}),
    }[case]
    assert results["ours"] == expected


@pytest.mark.parametrize("name", sorted(RETRIEVERS))
def test_precomputed_preferred_querier_fallback(name):
    """The hook takes the precomputed detections where the data has them and
    asks the querier (once, then from the data) where it has none."""
    mod = RETRIEVERS[name]
    data, _, _ = ot.synthetic_object_session()
    assert mod.PrecomputedBoundingBoxRetriever(data).retrieve_bounding_boxes(0) is not None
    calls, added = [], []

    class FakeQuerier:
        def retrieve_bounding_boxes(self, frame_id, camera_ids):
            calls.append(frame_id)
            return {}

    class FakeFrontend:
        def add_bounding_box_observations(self, f, c, bbs, observed):
            added.append((f, c, len(bbs), len(observed)))

    hook = mod.make_bb_frontend_hook_with_querier(FakeFrontend(), FakeQuerier(), [1])
    hook(data, None, 0)
    assert calls == [] and added == [
        (0, c, len(bbs), sum(c in cams for cams in data.features_for_frame(0).values()))
        for c, bbs in data.bounding_boxes[0].items()]
    missing = max(data.bounding_boxes) + 100
    hook(data, None, missing)
    hook(data, None, missing)
    assert calls == [missing]
