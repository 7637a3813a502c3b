"""The frozen generators draw what the program's own generators draw, seed
for seed, at the parameters of the cells and of chip_smoke.py's phases; the
session files are those the program's exporter writes."""

import csv
from pathlib import Path

import numpy as np
import pytest

from benchmark.traffic import files, object_session, problem as gen

SCALE = dict(n_poses=1024, n_points=16384, n_objects=64, obs_per_point=6, obs_per_object=12)
OBJECTS = dict(n_frames=64, n_features=1200, n_objects=16, seed=21, baseline=0.12,
               odom_noise=0.01)


def _port_problem(sizes, seed):
    from obvi_slam_tpu_torch import synthetic

    return synthetic.synthetic_problem(**sizes, seed=seed, device="cpu")


def _live(table, name):
    col = getattr(table, name).numpy()
    return col[table.mask.numpy()]


@pytest.mark.parametrize("sizes, seed", [
    (SCALE, 0),
    (dict(SCALE, n_poses=768), 2_718_281_828),
    (dict(n_poses=64, n_points=512, n_objects=8), 7),
])
def test_problem_matches_the_program(sizes, seed):
    raw = gen.synthetic_problem(**sizes, seed=seed)
    state0, state_gt, _, tables, _, free, _, _ = _port_problem(sizes, seed)
    np.testing.assert_array_equal(raw["poses"], state0.poses.numpy())
    np.testing.assert_array_equal(raw["points"], state0.points.numpy())
    np.testing.assert_array_equal(raw["objects"], state0.objects.numpy())
    np.testing.assert_array_equal(raw["gt_points"], state_gt.points.numpy())
    np.testing.assert_array_equal(raw["free_poses"], free.poses.numpy())
    for fam, cols in {
        "reproj": {"pose": "pose_idx", "point": "point_idx", "obs": "rect_obs",
                   "mult": "multiplier"},
        "bbox": {"obj": "obj_idx", "pose": "pose_idx", "corners": "rect_corners",
                 "sqrt_inf": "sqrt_inf"},
        "shape": {"obj": "obj_idx", "mean": "mean_dim", "sqrt_inf": "sqrt_inf"},
        "relpose": {"before": "before_idx", "after": "after_idx", "t": "meas_t",
                    "r": "meas_r", "sqrt_inf": "sqrt_inf"},
    }.items():
        for mine, theirs in cols.items():
            np.testing.assert_array_equal(raw[f"{fam}_{mine}"], _live(getattr(tables, fam),
                                                                      theirs))


def test_out_and_back_relabels_every_pose_index():
    raw = gen.synthetic_problem(n_poses=16, n_points=64, n_objects=2, seed=3)
    loop = gen.out_and_back(raw)
    for key in ("reproj_pose", "bbox_pose", "relpose_before", "relpose_after"):
        np.testing.assert_array_equal(loop["poses"][loop[key]], raw["poses"][raw[key]])
    np.testing.assert_array_equal(loop["poses"][[0, 1, 8, 15]], raw["poses"][[0, 2, 15, 1]])
    assert loop["free_poses"][0] == raw["free_poses"][0] == False  # noqa: E712
    spans = np.abs(np.subtract.outer(loop["reproj_pose"], loop["reproj_pose"])).max()
    assert spans > 8


def _port_session(params):
    from obvi_slam_tpu_torch import synthetic

    return synthetic.synthetic_object_session(**params)


@pytest.mark.parametrize("params", [
    OBJECTS,
    dict(n_frames=30, n_features=400, n_objects=4, seed=1_618_033_988, baseline=0.12,
         odom_noise=0.01),
    dict(),
])
def test_object_session_matches_the_program(params):
    s = object_session.synthetic_object_session(**params)
    data, gt_poses, gt_objects = _port_session(params)
    np.testing.assert_array_equal(s.gt_poses, gt_poses)
    np.testing.assert_array_equal(s.gt_objects, gt_objects)
    assert sorted(data.feature_tracks) == s.feat_ids.tolist()
    mine = {(j, f, c): p for j, f, c, p in zip(s.obs_feat.tolist(), s.obs_frame.tolist(),
                                               s.obs_cam.tolist(), s.obs_px)}
    theirs = {(j, f, c): p for j, track in data.feature_tracks.items()
              for f, by_cam in track.items() for c, p in by_cam.items()}
    assert mine.keys() == theirs.keys()
    np.testing.assert_allclose(np.array([mine[k] for k in theirs]),
                               np.array(list(theirs.values())), rtol=0, atol=1e-9)
    np.testing.assert_allclose(s.feat_init,
                               np.array([data.feature_init_positions[j] for j in s.feat_ids]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(s.init_poses, np.array([data.initial_poses[i]
                                                       for i in range(len(gt_poses))]),
                               rtol=0, atol=1e-12)
    dets = [(f, c, bb.corners) for f, by_cam in sorted(data.bounding_boxes.items())
            for c, bbs in by_cam.items() for bb in bbs]
    assert [(f, c) for f, c, _ in dets] == list(zip(s.det_frame.tolist(), s.det_cam.tolist()))
    np.testing.assert_allclose(s.det_px, np.array([d for _, _, d in dets]).reshape(-1, 4),
                               rtol=0, atol=1e-9)


def _tokens(path):
    with open(path) as f:
        return [row for row in csv.reader(f)] if path.suffix == ".csv" else \
            [line.split() for line in f]


def _same_file(a: Path, b: Path):
    ta, tb = _tokens(a), _tokens(b)
    assert len(ta) == len(tb), a.name
    for ra, rb in zip(ta, tb):
        assert len(ra) == len(rb), a.name
        for x, y in zip(ra, rb):
            if x != y:
                assert abs(float(x) - float(y)) <= 1e-9 * max(1.0, abs(float(y))), (a.name, x, y)


def test_session_files_match_the_program_exporter(tmp_path):
    from obvi_slam_tpu_torch import synthetic

    params = dict(n_frames=12, n_features=120, n_objects=4, seed=5, baseline=0.12,
                  odom_noise=0.01)
    mine = files.write_session(object_session.synthetic_object_session(**params),
                               tmp_path / "mine")
    data, gt, _ = synthetic.synthetic_object_session(**params)
    theirs = synthetic.export_session_files(data, gt, tmp_path / "theirs")
    names = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(mine) for p in mine.rglob("*") if p.is_file())
    for name in names:
        if (theirs / name).read_bytes() != (mine / name).read_bytes():
            _same_file(mine / name, theirs / name)
