"""obvi_slam_tpu_torch.visualization and the plotting CLIs against the JAX
package on the CPU at f64: the four plot functions and the plotting CLIs'
PNGs decode to the same pixels (Agg, in one process); the debug-image
visualizer's overlays equal the reference's per-object and per-feature
geometry (``obvi_slam_tpu.geometry``) at rtol 1e-12 and its PNGs decode to
the JAX ``SaveToFileVisualizer``'s pixels, on the JAX package's own cases
(tests/test_visualization.py: the inflated box, an object behind the
camera, the feature validity window) and on a seeded scene of several
objects and two cameras; the main CLI with ``--debug_images_output_directory``
writes the JAX CLI's image file names on an 8-frame object session;
``display_ltm`` prints what the JAX script prints."""

import contextlib
import importlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import geometry as jgeo
from obvi_slam_tpu import visualization as jviz
from obvi_slam_tpu.pose_graph import CameraInfo as JaxCameraInfo
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.runner import OptLogRecord as JaxOptLogRecord
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import visualization as viz
from obvi_slam_tpu_torch.cli import display_ltm as port_display_ltm
from obvi_slam_tpu_torch.cli import iteration_plotter as port_iteration_plotter
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as port_main
from obvi_slam_tpu_torch.pose_graph import CameraInfo
from obvi_slam_tpu_torch.runner import OptLogRecord
from torch_cli_helpers import export, input_args
from torch_object_helpers import object_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])


def jax_cli(name):
    return importlib.import_module(f"cli.{name}")


def pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


def assert_same_pixels(a, b):
    pa, pb = pixels(a), pixels(b)
    assert pa.shape == pb.shape
    assert np.array_equal(pa, pb), int((pa != pb).any(-1).sum())


def run_main(module, argv):
    """(exit code, stdout) of ``module.main(argv)`` in process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = module.main(argv)
    return code, buf.getvalue()


# ---- plot functions ---------------------------------------------------------


def test_plot_topdown_trajectory_pixels_equal(tmp_path):
    rng = np.random.default_rng(3)
    traj = np.cumsum(rng.normal(scale=0.2, size=(30, 6)), axis=0)
    traj[7] = np.nan
    gt = traj + rng.normal(scale=0.05, size=traj.shape)
    objects = {k: ("chair", np.r_[rng.normal(size=3), rng.uniform(-1, 1), rng.uniform(0.3, 1, 3)])
               for k in range(3)}
    gt_objects = {k: (c, e + 0.1) for k, (c, e) in objects.items()}
    for mod, name in ((jviz, "jax.png"), (viz, "port.png")):
        mod.plot_topdown_trajectory(str(tmp_path / name), {"est": traj, "gt": gt}, objects,
                                    gt_objects, title="t")
    assert_same_pixels(tmp_path / "jax.png", tmp_path / "port.png")


def test_plot_iteration_costs_pixels_equal(tmp_path):
    rng = np.random.default_rng(4)
    rows = [(i, bool(i % 3 == 0), 1, 0, 10, 100, 2, float(c0), float(c1), 5, "CONVERGENCE")
            for i, (c0, c1) in enumerate(rng.uniform(1e-3, 1e3, size=(25, 2)))]
    viz.plot_iteration_costs(str(tmp_path / "port.png"), [OptLogRecord(*r) for r in rows])
    jviz.plot_iteration_costs(str(tmp_path / "jax.png"), [JaxOptLogRecord(*r) for r in rows])
    assert_same_pixels(tmp_path / "jax.png", tmp_path / "port.png")


def test_plot_waypoint_cdfs_pixels_equal(tmp_path):
    rng = np.random.default_rng(5)
    t = {"ours": list(rng.uniform(0, 0.5, 20)), "ref": list(rng.uniform(0, 0.8, 9)), "none": []}
    r = {"ours": list(rng.uniform(0, 0.1, 20)), "ref": list(rng.uniform(0, 0.2, 9))}
    for mod, name in ((jviz, "jax"), (viz, "port")):
        mod.plot_waypoint_cdfs(str(tmp_path / f"{name}.png"), t, r)
        mod.plot_waypoint_cdfs(str(tmp_path / f"{name}_t.png"), t)
    assert_same_pixels(tmp_path / "jax.png", tmp_path / "port.png")
    assert_same_pixels(tmp_path / "jax_t.png", tmp_path / "port_t.png")


def test_plot_feature_cloud_pixels_equal(tmp_path):
    rng = np.random.default_rng(6)
    points, traj = rng.normal(size=(200, 3)), np.cumsum(rng.normal(size=(10, 6)), axis=0)
    for mod, name in ((jviz, "jax.png"), (viz, "port.png")):
        mod.plot_feature_cloud(str(tmp_path / name), points, traj, title="cloud")
    assert_same_pixels(tmp_path / "jax.png", tmp_path / "port.png")


# ---- SaveToFileVisualizer ---------------------------------------------------


def both_graphs(cameras, build):
    """The same pose graph in both packages: ``cameras`` {id: (K, R, t)}
    and ``build(pg)`` adding its content."""
    graphs = []
    for pg_cls, cam_cls in ((JaxPoseGraph, JaxCameraInfo), (ot.PoseGraph, CameraInfo)):
        pg = pg_cls({c: cam_cls(k, r, t) for c, (k, r, t) in cameras.items()})
        pg.shape_mean_and_cov_by_class = {"chair": (np.array([0.6, 0.6, 1.0]), np.eye(3) * 0.1)}
        build(pg)
        graphs.append(pg)
    return graphs


def reference_overlays(pg, frame_id, cam_ids):
    """The JAX visualizer's per-object and per-feature geometry
    (visualization.py:296-364), one call of ``obvi_slam_tpu.geometry`` per
    object and per feature: {(camera, object): pixel box} of the boxes it
    keeps (before the image-bounds test) and {(camera, feature index in the
    window list): reprojected pixel}."""
    pose = np.asarray(pg.get_robot_pose(frame_id))
    boxes, reproj = {}, {}
    for cam_id in cam_ids:
        cam = pg.cameras[cam_id]
        k, r = cam.intrinsics, cam.extrinsics_r.T
        t = -cam.extrinsics_r.T @ cam.extrinsics_t
        for obj_id, node in pg.objects.items():
            _, depth = jgeo.project_point_rectified(pose, np.asarray(node.ellipsoid[:3]), r, t)
            if float(depth) <= 0:
                continue
            cr, valid = jgeo.ellipsoid_corners_rectified(node.ellipsoid, pose, r, t)
            if not bool(valid):
                continue
            cr = np.asarray(cr)
            boxes[(cam_id, obj_id)] = np.array([
                k[0, 0] * cr[0] + k[0, 2], k[0, 0] * cr[1] + k[0, 2],
                k[1, 1] * cr[2] + k[1, 2], k[1, 1] * cr[3] + k[1, 2]])
    feats = []
    for past in range(0, frame_id + 1):
        for idx in pg.visual_factors_by_frame.get(past, []):
            feats.append(pg.visual_factors[idx])
    for i, f in enumerate(feats):
        cam = pg.cameras[f.camera_id]
        pt = pg.features.get(f.feature_id)
        if pt is None:
            continue
        xy, depth = jgeo.project_point_rectified(
            pose, np.asarray(pt), cam.extrinsics_r.T, -cam.extrinsics_r.T @ cam.extrinsics_t)
        if float(depth) <= 0:
            continue
        k = cam.intrinsics
        reproj[(f.camera_id, i)] = np.array([float(k[0, 0] * xy[0] + k[0, 2]),
                                             float(k[1, 1] * xy[1] + k[1, 2])])
    return boxes, reproj


def assert_overlays_match(ov, reference):
    boxes, reproj = reference
    ours = {(c, o): px for c, o, px in ov.predicted}
    assert ours.keys() == boxes.keys()
    for key, px in boxes.items():
        np.testing.assert_allclose(ours[key], px, rtol=1e-12, atol=0)
    got = {(f[0], i): r for i, (f, r) in enumerate(zip(ov.feats, ov.reprojections))
           if r is not None}
    assert got.keys() == reproj.keys()
    for key, px in reproj.items():
        np.testing.assert_allclose(got[key], px, rtol=1e-12, atol=0)


def draw_both(tmp_path, jax_pg, port_pg, frontends, frame_id, config_kw, **kw):
    """Both visualizers on one frame: (JAX paths, port paths, port
    overlays)."""
    jv = jviz.SaveToFileVisualizer(str(tmp_path / "jax"),
                                   jviz.SaveToFileVisualizerConfig(**config_kw),
                                   img_heights_and_widths={1: (480, 640), 2: (480, 640)})
    pv = viz.SaveToFileVisualizer(str(tmp_path / "port"),
                                  viz.SaveToFileVisualizerConfig(**config_kw),
                                  img_heights_and_widths={1: (480, 640), 2: (480, 640)},
                                  device="cpu")
    jpaths = jv.bounding_box_front_end_visualization(jax_pg, frontends, frame_id, **kw)
    ppaths = pv.bounding_box_front_end_visualization(port_pg, frontends, frame_id, **kw)
    assert [os.path.basename(p) for p in jpaths] == [os.path.basename(p) for p in ppaths]
    for a, b in zip(jpaths, ppaths):
        assert_same_pixels(a, b)
    return jpaths, ppaths, pv.frame_overlays(port_pg, frontends, frame_id, **kw)


class FakePending:
    class Obs:
        frame_id, camera_id = 0, 1
        corners = np.array([100.0, 160.0, 100.0, 180.0])

    observations = [Obs()]


class FakeFrontend:
    pending = [FakePending()]


def test_save_to_file_visualizer_matches_jax(tmp_path):
    """tests/test_visualization.py::test_save_to_file_visualizer's scene:
    every colour drawn, the inflated box at the full inflation per side."""
    def build(pg):
        pg.add_frame(0, np.zeros(6))
        pg.add_feature(7, np.array([0.5, 0.2, 8.0]))
        pg.add_visual_factor(0, 1, 7, np.array([352.0, 252.0]), 1.3)
        obj_id = pg.add_new_ellipsoid(np.array([1.0, 0.3, 7.0, 0.0, 0.6, 0.6, 1.0]), "chair")
        pg.add_object_observation(obj_id, 0, 1, np.array([330.0, 420.0, 220.0, 330.0]),
                                  np.eye(4) * 900.0)

    jpg, ppg = both_graphs({1: (K, np.eye(3), np.zeros(3))}, build)
    _, paths, ov = draw_both(tmp_path, jpg, ppg, FakeFrontend(), 0,
                             dict(bounding_box_inflation_size=10.0))
    assert [os.path.basename(p) for p in paths] == ["bb_assoc_frame_000000_cam_1.png"]
    assert_overlays_match(ov, reference_overlays(jpg, 0, [1]))
    img = pixels(paths[0])
    flat = img.reshape(-1, 3)
    for color in ((255, 0, 0), (186, 0, 247), (0, 200, 0), (255, 255, 0)):
        assert (flat == np.array(color)).all(axis=1).any(), color
    xs = np.where((img == np.array([255, 76, 76])).all(axis=2))[1]
    assert xs.size and xs.min() in (319, 320, 321), xs.min()


def test_save_to_file_visualizer_behind_camera(tmp_path):
    """An ellipsoid behind the camera draws no (mirrored) predicted box: the
    centre-depth gate comes before the corner math."""
    def build(pg):
        pg.add_frame(0, np.zeros(6))
        pg.add_feature(3, np.array([0.0, 0.0, 8.0]))
        pg.add_visual_factor(0, 1, 3, np.array([320.0, 240.0]), 1.3)
        pg.add_new_ellipsoid(np.array([0.0, 0.0, -7.0, 0.0, 0.6, 0.6, 1.0]), "chair")

    jpg, ppg = both_graphs({1: (K, np.eye(3), np.zeros(3))}, build)
    _, paths, ov = draw_both(tmp_path, jpg, ppg, None, 0, {})
    assert not ov.predicted
    assert_overlays_match(ov, reference_overlays(jpg, 0, [1]))
    assert not (pixels(paths[0]).reshape(-1, 3) == np.array([0, 200, 0])).all(axis=1).any()


def test_save_to_file_visualizer_feature_validity_window(tmp_path):
    """Only the features observed within the window (lower bound
    max(0, frame - window)) are drawn."""
    def build(pg):
        for i in range(6):
            pg.add_frame(i, np.zeros(6))
        pg.add_feature(1, np.array([0.0, 0.0, 8.0]))
        pg.add_visual_factor(0, 1, 1, np.array([100.0, 100.0]), 1.3)  # old
        pg.add_visual_factor(4, 1, 1, np.array([200.0, 200.0]), 1.3)  # in the window

    jpg, ppg = both_graphs({1: (K, np.eye(3), np.zeros(3))}, build)
    _, paths, ov = draw_both(tmp_path, jpg, ppg, None, 5, dict(feature_validity_window=2),
                             draw_feature_reprojections=False)
    assert [f[2] for f in ov.feats] == [1] and ov.reprojections == [None]
    ys, xs = np.where((pixels(paths[0]) == np.array([255, 255, 0])).all(axis=2))
    assert xs.size and (np.abs(xs - 200) <= 3).all()


def test_save_to_file_visualizer_seeded_scene_matches_jax(tmp_path):
    """A seeded scene: two cameras (the second rotated and offset), objects
    in front of, behind and beside the cameras, features in front and
    behind and one with no position, associated and pending boxes, a
    nonzero pose: overlays at rtol 1e-12, pixels equal, per camera."""
    rng = np.random.default_rng(11)
    from scipy.spatial.transform import Rotation

    r2 = Rotation.from_euler("y", 0.3).as_matrix()
    cameras = {1: (K, np.eye(3), np.zeros(3)), 2: (K * [[1.1], [1.1], [1]], r2,
                                                   np.array([0.3, 0.0, 0.1]))}
    pose = np.r_[rng.normal(scale=0.3, size=3), rng.normal(scale=0.05, size=3)]
    ellipsoids = [np.r_[rng.uniform(-2, 2), rng.uniform(-1, 1), z, rng.uniform(-1, 1),
                        rng.uniform(0.3, 1.2, 3)] for z in (4.0, 6.5, 9.0, -5.0, 0.2)]
    ellipsoids.append(np.array([30.0, 0.0, 5.0, 0.0, 0.6, 0.6, 1.0]))  # beside the image
    points = np.c_[rng.uniform(-3, 3, (12, 2)), rng.uniform(2, 12, 12)]
    points[3, 2] = -4.0  # behind the camera
    feature_pixels = rng.uniform([0, 0], [640, 480], size=(len(points) + 1, 2))
    boxes = np.sort(rng.uniform(0, 600, (len(ellipsoids), 4)), axis=1)[:, [0, 2, 1, 3]]

    def build(pg):
        pg.add_frame(0, np.zeros(6))
        pg.add_frame(1, pose)
        for i, p in enumerate(points):
            pg.add_feature(i, p)
        for i, px in enumerate(feature_pixels):  # the last feature has no position
            pg.add_visual_factor(1 if i % 4 else 0, 1 + i % 2, i, px, 1.3)
        for e, box in zip(ellipsoids, boxes):
            obj = pg.add_new_ellipsoid(e, "chair")
            pg.add_object_observation(obj, 1, 1 + obj % 2, box, np.eye(4))

    class Pending:
        class Obs:
            frame_id, camera_id = 1, 2
            corners = np.array([50.0, 90.0, 60.0, 200.0])

        observations = [Obs()]

    class Frontend:
        pending = [Pending()]

    jpg, ppg = both_graphs(cameras, build)
    _, paths, ov = draw_both(tmp_path, jpg, ppg, Frontend(), 1,
                             dict(bounding_box_inflation_size=4.0))
    assert len(paths) == 2 and ov.predicted and ov.pending
    assert sum(r is not None for r in ov.reprojections) < len(ov.feats)
    assert_overlays_match(ov, reference_overlays(jpg, 1, [1, 2]))


def test_visualizer_without_output_directory_draws_nothing():
    pg = ot.PoseGraph({1: CameraInfo(K, np.eye(3), np.zeros(3))})
    pg.add_frame(0, np.zeros(6))
    assert viz.SaveToFileVisualizer("", device="cpu").bounding_box_front_end_visualization(
        pg, None, 0) == []
    assert viz.SaveToFileVisualizer("", device="cpu").frame_overlays(pg, None, 0) is None


# ---- the main CLI's debug images ---------------------------------------------


def test_main_cli_debug_images_match_jax(tmp_path):
    """``--debug_images_output_directory`` on an 8-frame object session:
    the port's CLI writes the JAX CLI's image file names."""
    data, gt, _ = ot.synthetic_object_session(n_frames=8)
    d = export(data, gt, tmp_path / "files", object_config(jcfg))
    jax_main = jax_cli("offline_object_visual_slam_main")
    assert jax_main.main(input_args(d) + [
        "--platform", "cpu", "--f64", "--debug_images_output_directory", str(tmp_path / "jax")
    ]) == 0
    assert port_main.main(input_args(d) + [
        "--device", "cpu", "--f64", "--debug_images_output_directory", str(tmp_path / "port")
    ]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and sorted(os.listdir(tmp_path / "port")) == names


# ---- display_ltm and iteration_plotter --------------------------------------


def test_display_ltm_prints_what_jax_prints(tmp_path):
    rng = np.random.default_rng(8)
    ltm = ot.LongTermObjectMap()
    for k in (0, 3, 12):
        ltm.ellipsoids[k] = ("chair" if k else "table",
                             np.r_[rng.normal(size=3) * 5, rng.uniform(-3, 3),
                                   rng.uniform(0.2, 2, 3)])
        a = rng.normal(size=(7, 7))
        ltm.covariances[k] = a @ a.T * 1e-3
        ltm.front_end_data[k] = {}
    path = str(tmp_path / "ltm.json")
    ltm.save(path)
    for extra in ([], ["--covariances"]):
        j = run_main(jax_cli("display_ltm"), [path] + extra)
        p = run_main(port_display_ltm, [path] + extra)
        assert j == p and j[0] == 0 and "Long-term map: 3 objects" in p[1]


def test_iteration_plotter_matches_jax(tmp_path):
    """Per-type plots from ceres_iterations_<type>.csv files: the same
    printed lines (the plot directory aside) and the same pixels; no CSV
    exits 1 in both."""
    rng = np.random.default_rng(9)
    logs = tmp_path / "logs"
    logs.mkdir()
    from obvi_slam_tpu_torch.optlog import _HEADER

    for opt_type, n_solves in (("lba_phase_1", 4), ("pgo", 2), ("pending_obj_est", 3)):
        with open(logs / f"ceres_iterations_{opt_type}.csv", "w") as f:
            f.write(_HEADER + "\n")
            for s in range(n_solves):
                cost = rng.uniform(10, 100)
                for it in range(int(rng.integers(2, 9))):
                    change = cost * rng.uniform(0.1, 0.5)
                    cost -= change
                    f.write(f"{opt_type}_{s},{it},{cost},{change},{rng.uniform()},"
                            f"{rng.uniform() / 9},{int(rng.uniform() > 0.2)}\n")
    runs = {}
    for label, mod in (("jax", jax_cli("iteration_plotter")), ("port", port_iteration_plotter)):
        code, out = run_main(mod, ["--logs_directory", str(logs),
                                   "--plots_dir", str(tmp_path / label)])
        assert code == 0
        runs[label] = out.replace(str(tmp_path / label), "<plots>")
    assert runs["jax"] == runs["port"] and runs["port"].count("solves ->") == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for name in names:
        assert_same_pixels(tmp_path / "jax" / name, tmp_path / "port" / name)
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (jax_cli("iteration_plotter"), port_iteration_plotter):
        with contextlib.redirect_stderr(io.StringIO()):
            assert mod.main(["--logs_directory", str(empty), "--plots_dir",
                             str(tmp_path / "none")]) == 1


@pytest.mark.parametrize("module", ["obvi_slam_tpu_torch.cli.display_ltm",
                                    "obvi_slam_tpu_torch.cli.iteration_plotter"])
def test_plotting_cli_help_in_a_fresh_interpreter(module):
    """One ``__main__`` path per group: ``python -m <module> --help``."""
    import subprocess

    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and "usage:" in out.stdout, out.stderr
