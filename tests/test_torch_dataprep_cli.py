"""The port's data-preparation entry points against the JAX package's
repo-root ``cli/`` scripts on the CPU: each pair runs in process on the same
inputs, made from a seed with numpy, and must return the same code, print
the same lines and write the same files byte for byte
(``torch_cli_compare.run_both``); one ``python -m`` run checks the
``__main__`` path. Also: every entry point of the port accepts the flags of
its JAX script (``--platform`` as ``--device``)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch.io import timestamped as tio
from torch_cli_compare import (
    REPO,
    all_cli_names,
    assert_same_tree,
    cli_arguments,
    jax_cli,
    port_cli,
    run_both,
    run_main,
)

POSE_HEADER = "node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w"
TS_POSE_HEADER = "seconds,nanoseconds,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w"


def random_poses(rng, n, step=0.3):
    """n poses [t, rotvec] along a noisy path."""
    t = np.cumsum(rng.normal(scale=step, size=(n, 3)), axis=0)
    return np.c_[t, rng.normal(scale=0.2, size=(n, 3))]


def write_timestamped(path, stamps, poses):
    with open(path, "w") as f:
        f.write(TS_POSE_HEADER + "\n")
        for (s, ns), p in zip(stamps, poses):
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{s},{ns},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")


# ---- the flags -----------------------------------------------------------------


@pytest.mark.parametrize("name", all_cli_names())
def test_cli_accepts_the_jax_flags(name):
    """Every flag and positional argument of the JAX script is the port's
    (``--platform`` becomes ``--device``); the entry points this slice
    ports take exactly those."""
    j_opts, j_pos = cli_arguments(jax_cli(name))
    p_opts, p_pos = cli_arguments(port_cli(name))
    j_opts = {"--device" if o == "--platform" else o for o in j_opts}
    assert j_opts <= p_opts and j_pos == p_pos
    if name not in ("offline_object_visual_slam_main", "sequence_executor",
                    "run_opt_from_pg_state", "ltm_extraction_only",
                    "debug_jacobian_hessian_diagonal"):
        assert j_opts == p_opts, sorted(p_opts - j_opts)


# ---- ORB output preparation -----------------------------------------------------


def raw_orb_matches(root, rng, n_frames=6):
    """Raw stereo-ORB match files: two per frame (against frame-1 and
    frame+1), negative depths, a file against a frame that is not a
    neighbour and an unparseable name."""
    root.mkdir()
    for frame in range(n_frames):
        pose = " ".join(str(v) for v in rng.normal(size=7))
        for other in (frame - 1, frame + 1, frame + 5):
            lines = [str(frame), pose]
            for feat in rng.choice(40, size=8, replace=False):
                x, y = rng.uniform(0, 640), rng.uniform(0, 480)
                depth = rng.uniform(-1, 10)
                lines.append(f"{feat} {x} {y} {depth} {x - 7.5} {y}")
            (root / f"{frame}_x_{100 + frame * 0.1:.1f}_vs_{other}.txt").write_text(
                "\n".join(lines) + "\n")
    (root / "notes_about_run.txt").write_text("x\n")


def test_orb_stereo_reformat_data(tmp_path):
    rng = np.random.default_rng(20)
    raw_orb_matches(tmp_path / "raw", rng)
    _, out = run_both("orb_stereo_reformat_data",
                      lambda o: ["-i", str(tmp_path / "raw"), "-o", str(o / "orb")], tmp_path)
    assert (out / "orb" / "depths" / "3.txt").exists()


def test_initialize_traj_and_feats_from_orb_out(tmp_path):
    """Velocities chained into a trajectory and first-observation depths
    unprojected; the script writes into the ORB output directory, so each
    package gets its own copy."""
    rng = np.random.default_rng(21)
    raw, calib, orb = tmp_path / "raw", tmp_path / "calib", tmp_path / "orb"
    for d in (raw / "velocities", raw / "depths", calib, orb):
        d.mkdir(parents=True)
    (calib / "camera_matrix.txt").write_text("500 0 320\n0 510 240\n0 0 1\n")
    q = Rotation.from_rotvec(rng.normal(scale=0.1, size=3)).as_quat()
    (calib / "extrinsics.txt").write_text(" ".join(str(v) for v in [0.1, -0.05, 0.2, *q]))
    for frame in range(1, 7):
        q = Rotation.from_rotvec(rng.normal(scale=0.05, size=3)).as_quat()
        (raw / "velocities" / f"{frame}.txt").write_text(
            " ".join(str(v) for v in [*rng.normal(scale=0.3, size=3), *q]))
        obs, depths = [str(frame), "0 0 0 0 0 0 1"], []
        for feat in rng.choice(30, size=10, replace=False):
            x, y = rng.uniform(0, 640), rng.uniform(0, 480)
            obs.append(f"{feat} 1 {x} {y} 2 {x - 8} {y}")
            depths.append(f"{feat} {rng.uniform(-1, 9)}")
        (orb / f"{frame:06d}.txt").write_text("\n".join(obs) + "\n")
        (raw / "depths" / f"{frame}.txt").write_text("\n".join(depths) + "\n")
    run_both("initialize_traj_and_feats_from_orb_out",
             lambda o: ["--raw_data_path", str(raw), "--calibration_path", str(calib),
                        "--processed_data_path", str(o / "orb")],
             tmp_path, prepare=lambda o: shutil.copytree(orb, o / "orb"))


@pytest.fixture(scope="module")
def visual_files(tmp_path_factory):
    data, gt, _ = ot.synthetic_session(n_frames=12, n_features=40)
    return ot.synthetic.export_session_files(data, gt, tmp_path_factory.mktemp("visual"))


def test_orb_trajectory_sparsifier(visual_files, tmp_path):
    required = tmp_path / "required.json"
    required.write_text(json.dumps([5]))
    _, out = run_both(
        "orb_trajectory_sparsifier",
        lambda o: ["--input_poses_file", str(visual_files / "poses.csv"),
                   "--input_feature_obs_dir", str(visual_files / "orb_out"),
                   "--output_poses_file", str(o / "poses.csv"),
                   "--output_feature_obs_dir", str(o / "orb_out"),
                   "--required_frames_file", str(required),
                   "--max_pose_inc_threshold_transl", "0.45"],
        tmp_path)
    kept = ot.io.read_poses_by_node_id(str(out / "poses.csv"))
    assert 2 < len(kept) < 12
    tracks, _ = ot.io.read_orb_output_directory(str(out / "orb_out"))
    assert tracks


def test_interpolate_poses_with_required_nodes(tmp_path):
    rng = np.random.default_rng(22)
    stamps = [(100 + i, int(rng.integers(0, 10**9))) for i in range(10)]
    order = rng.permutation(10)  # the script sorts by time
    write_timestamped(tmp_path / "poses.csv", [stamps[i] for i in order],
                      random_poses(rng, 10)[order])
    required = [(99, 0)] + [(100 + int(s), int(ns)) for s, ns in
                            zip(rng.uniform(0, 9, 8), rng.integers(0, 10**9, 8))] + [(120, 5)]
    tio.write_timestamps(str(tmp_path / "required.csv"), required)
    run_both("interpolate_poses_with_required_nodes",
             lambda o: ["--poses_by_timestamp_file", str(tmp_path / "poses.csv"),
                        "--required_timestamps_file", str(tmp_path / "required.csv"),
                        "--poses_out_file", str(o / "interp.csv")], tmp_path)


def test_gt_transformer(tmp_path):
    rng = np.random.default_rng(23)
    write_timestamped(tmp_path / "traj.csv", [(50 + i, i * 1000) for i in range(8)],
                      random_poses(rng, 8))
    q = Rotation.from_rotvec(rng.normal(scale=0.3, size=3)).as_quat()
    t = rng.normal(size=3)
    (tmp_path / "extr.csv").write_text(
        "transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n"
        + ",".join(str(v) for v in [*t, *q]) + "\n" + ",".join(str(v) for v in [*t, *q]) + "\n")
    code, _, err = run_both(
        "gt_transformer",
        lambda o: ["--interpolated_traj", str(tmp_path / "traj.csv"),
                   "--lego_loam_frame_to_bl_extrinsics", str(tmp_path / "extr.csv"),
                   "--interp_out_file", str(o / "gt.csv")], tmp_path)[0]
    assert code == 0 and "more than one pose" in err


# ---- trajectory formatting ------------------------------------------------------


def test_utvslam_out_to_poses_by_timestamp(tmp_path):
    rng = np.random.default_rng(24)
    poses = random_poses(rng, 6)
    with open(tmp_path / "robot_poses.csv", "w") as f:
        f.write(POSE_HEADER + "\n")
        for i, p in enumerate(poses):
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{i},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    tio.write_node_ids_and_timestamps(str(tmp_path / "nodes.csv"),
                                      [(0, (10, 0)), (2, (12, 5)), (5, (15, 7)), (9, (99, 0))])
    code, _, err = run_both(
        "utvslam_out_to_poses_by_timestamp",
        lambda o: ["--poses_by_frame_file", str(tmp_path / "robot_poses.csv"),
                   "--frames_for_timestamps_file", str(tmp_path / "nodes.csv"),
                   "--poses_by_timestamp_out_file", str(o / "by_ts.csv")], tmp_path)[0]
    assert code == 0 and "no pose for node 9" in err


@pytest.mark.parametrize("labels", ["3,4:r,9", "3,4"], ids=["labelled", "too_few_labels"])
def test_waypoint_timestamp_extractor(tmp_path, labels):
    rng = np.random.default_rng(25)
    triggers = sorted((int(s), int(ns)) for s, ns in zip(
        [100, 101, 110, 130], rng.integers(0, 10**9, 4)))
    tio.write_timestamps(str(tmp_path / "triggers.csv"), triggers)
    tio.write_timestamps(str(tmp_path / "images.csv"),
                         [(t, int(ns)) for t, ns in zip(range(95, 140),
                                                         rng.integers(0, 10**9, 45))])
    code = run_both(
        "waypoint_timestamp_extractor",
        lambda o: ["--waypoint_trigger_timestamps_file", str(tmp_path / "triggers.csv"),
                   "--image_timestamps_file", str(tmp_path / "images.csv"),
                   "--timestamps_for_waypoints_out_file", str(o / "waypoints.csv"),
                   "--labels", labels], tmp_path)[0][0]
    assert code == (0 if labels.count(",") == 2 else 1)


def test_traj_length_evaluator(tmp_path):
    rng = np.random.default_rng(26)
    paths = []
    for k in range(2):
        path = tmp_path / f"traj{k}.csv"
        write_timestamped(path, [(i, 0) for i in range(7)], random_poses(rng, 7))
        paths.append(str(path))
    (_, out, _), _ = run_both(
        "traj_length_evaluator",
        lambda o: ["--trajectory_files", ",".join(paths), "--output_file",
                   str(o / "lengths.json")], tmp_path)
    assert "total:" in out


def test_sequence_file_writer(tmp_path):
    run_both("sequence_file_writer",
             lambda o: ["--sequence_file_directory", str(o / "seqs"), "--sequence_id", "seq_v1",
                        "--bags", "bagA:waypoints_A, bagB,,bagC:w:c"], tmp_path)


def test_convert_object_detections_from_yaml(tmp_path):
    rng = np.random.default_rng(27)
    tracks = []
    for t in range(3):
        track = []
        for _ in range(int(rng.integers(1, 4))):
            x, y, z, qx, qy, qz, qw, length, width, height = (
                float(v) for v in rng.normal(size=10))
            track.append(f"      - label: {['chair', 'table'][t % 2]}\n"
                         f"        translation: {{x: {x}, y: {y}, z: {z}}}\n"
                         f"        rotation: {{w: {qw}, x: {qx}, y: {qy}, z: {qz}}}\n"
                         f"        box: {{length: {length}, width: {width}, "
                         f"height: {height}}}\n")
        tracks.append("  - track:\n" + "".join(track))
    (tmp_path / "objs.yaml").write_text("tracks:\n" + "".join(tracks))
    (tmp_path / "broken.yaml").write_text("tracks: [unclosed\n")
    for name in ("objs", "broken"):
        run_both("convert_object_detections_from_yaml",
                 lambda o: ["--convert_object_detections_from_yaml",
                            str(tmp_path / f"{name}.yaml"),
                            "--obj_output_file_name", str(o / "objs.csv")], tmp_path / name)


# ---- detections --------------------------------------------------------------


DETECTOR = """#!/usr/bin/env python
import json, sys
for line in sys.stdin:
    req = json.loads(line)
    n = len(req["image_path"])
    dets = [
        {"label": "chair", "conf": 0.5 + n % 5 / 10, "xyxy": [10 + n, 20, 110, 220]},
        {"label": "bench", "conf": 0.2, "xyxy": [30, 40, 90, 100 + n]},
        {"label": "couch", "conf": 0.7, "xyxy": [10, 20, 6000, 220]},
    ]
    print(json.dumps({"detections": dets}), flush=True)
"""


def test_extract_all_bounding_boxes(tmp_path):
    images = tmp_path / "images"
    for cam in (1, 2):
        (images / str(cam)).mkdir(parents=True)
        for frame in range(3):
            (images / str(cam) / f"{frame}.png").write_bytes(b"fake")
    (images / "notes").mkdir()
    (tmp_path / "detector.py").write_text(DETECTOR)
    command = f"{sys.executable} {tmp_path / 'detector.py'}"
    (_, out, _), d = run_both(
        "extract_all_bounding_boxes",
        lambda o: ["--images_dir", str(images), "--detector_command", command,
                   "--output_file", str(o / "bbs.csv"), "--min_confidence", "0.3"], tmp_path)
    assert "detections over 6 images" in out
    bbs = ot.io.read_bounding_boxes_by_node_id(str(d / "bbs.csv"))
    assert set(bbs) == {0, 1, 2}


def test_oa_slam_data_generator(tmp_path):
    rng = np.random.default_rng(28)
    root = tmp_path / "images"
    for cam in (1, 2):
        (root / str(cam)).mkdir(parents=True)
        for frame in range(3):
            (root / str(cam) / f"{frame}.png").write_bytes(rng.bytes(32))
    with open(tmp_path / "bbs.csv", "w") as f:
        f.write("min_pixel_x,min_pixel_y,max_pixel_x,max_pixel_y,semantic_class,node_id,"
                "camera_id,detection_confidence\n")
        for _ in range(8):
            x0, y0 = rng.uniform(0, 300, 2)
            f.write(f"{x0},{y0},{x0 + 50},{y0 + 80},{['chair', 'table'][rng.integers(2)]},"
                    f"{rng.integers(3)},{rng.integers(1, 3)},{rng.uniform()}\n")
    tio.write_node_ids_and_timestamps(str(tmp_path / "nodes.csv"),
                                      [(i, (5 + i, 0)) for i in range(3)])
    (tmp_path / "classes.csv").write_text("class_name,class_id\nchair,56\ntable,60\n")
    run_both("oa_slam_data_generator",
             lambda o: ["--images_root_directory", str(root),
                        "--bounding_boxes_by_node_id_file", str(tmp_path / "bbs.csv"),
                        "--nodes_by_timestamp_file", str(tmp_path / "nodes.csv"),
                        "--class_ids_file", str(tmp_path / "classes.csv"),
                        "--oa_slam_data_output_directory", str(o / "oa")], tmp_path)


def test_dataprep_main_in_a_fresh_interpreter(tmp_path):
    """One ``__main__`` path of the group: ``python -m`` the port's
    reformatter writes what the JAX script writes in process."""
    rng = np.random.default_rng(29)
    raw_orb_matches(tmp_path / "raw", rng)
    code, _, _ = run_main(jax_cli("orb_stereo_reformat_data"),
                          ["-i", str(tmp_path / "raw"), "-o", str(tmp_path / "jax")])
    assert code == 0
    out = subprocess.run(
        [sys.executable, "-m", "obvi_slam_tpu_torch.cli.orb_stereo_reformat_data",
         "-i", str(tmp_path / "raw"), "-o", str(tmp_path / "port")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
