"""The port's evaluation and comparison entry points against the JAX
package's repo-root ``cli/`` scripts on the CPU: each pair runs in process
on the same inputs, made from a seed with numpy, and must return the same
code, print the same lines and write the same files byte for byte
(``torch_cli_compare.run_both``; the metric files are JSON written from the
same numpy arithmetic, the plots the same Agg PNGs). The one-session
estimator is held to the JAX script's steps (each step's module and flags)
and run once as ``python -m`` on an exported session on the CPU; the
comparison launchers in their dry-run and fake-command modes."""

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
from obvi_slam_tpu_torch.metrics import schema
from torch_cli_compare import REPO, jax_cli, port_cli, run_both


def compose(a, b):
    ra, rb = Rotation.from_rotvec(a[3:6]), Rotation.from_rotvec(b[3:6])
    return np.r_[ra.apply(b[:3]) + a[:3], (ra * rb).as_rotvec()]


def base_link_path(rng, n):
    t = np.c_[0.5 * np.arange(n), 0.1 * np.sin(0.3 * np.arange(n)), np.zeros(n)]
    return [np.r_[t[i], [0, 0, 0.05 * i] + 0.01 * rng.normal(size=3)] for i in range(n)]


def write_extrinsics(path, pose):
    q = Rotation.from_rotvec(pose[3:6]).as_quat()
    path.write_text("transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n"
                    + ",".join(str(v) for v in [*pose[:3], *q]) + "\n")


def write_tum(path, entries):
    with open(path, "w") as f:
        f.write("# t tx ty tz qx qy qz qw\n")
        for (s, ns), pose in entries:
            if pose is None:
                continue
            q = Rotation.from_rotvec(pose[3:6]).as_quat()
            f.write(f"{s + ns * 1e-9} " + " ".join(str(v) for v in [*pose[:3], *q]) + "\n")


@pytest.fixture(scope="module")
def approach(tmp_path_factory):
    """Two sessions over one base-link path, 14 frames each: a comparison
    algorithm's noisy estimates in its sensor frame (session A with a lost
    frame and a lost tail), ground truth in a third frame, waypoints 7 and
    8 visited by both, odometry for session A, and the calibration files;
    trajectories as the optional-pose CSV, the plain CSV and TUM."""
    rng = np.random.default_rng(30)
    root = tmp_path_factory.mktemp("approach")
    ext, gt_ext, world = (np.r_[rng.normal(scale=0.2, size=3), rng.normal(scale=0.1, size=3)]
                          for _ in range(3))
    bl = base_link_path(rng, 14)
    seq = {"sequence_info": {"seq_id": "s", "sequence": [
        {"bag_base_name": "bagA", "waypoint_file_base_name": {"has_v": 1, "v": "wpA"}},
        {"bag_base_name": "bagB", "waypoint_file_base_name": {"has_v": 1, "v": "wpB.csv"}}]}}
    (root / "seq.json").write_text(json.dumps(seq))
    for d in ("wps", "calib", "odom"):
        (root / d).mkdir()
    for idx, name in enumerate(["0_bagA", "1_bagB"]):
        base = 100 + 50 * idx
        est, gt = [], []
        for i, b in enumerate(bl):
            ts = (base + i, 250_000_000)
            noisy = np.r_[b[:3] + rng.normal(scale=0.02, size=3),
                          b[3:] + rng.normal(scale=0.005, size=3)]
            lost = idx == 0 and (i == 5 or i >= 11)
            est.append((ts, None if lost else compose(world, compose(noisy, ext))))
            gt.append((ts, compose(b, gt_ext)))
        (root / "est" / name).mkdir(parents=True)
        (root / "gt" / name).mkdir(parents=True)
        tio.write_optional_poses_with_timestamps(str(root / "est" / name / "trajectory.csv"), est)
        tio.write_poses_with_timestamps(str(root / "est" / name / "nolost.csv"),
                                        [(t, p) for t, p in est if p is not None])
        write_tum(root / "est" / name / "trajectory.txt", est)
        tio.write_poses_with_timestamps(
            str(root / "gt" / name / "interpolated_lego_loam_poses.csv"), gt)
        tio.write_timestamps_and_waypoints(
            str(root / "wps" / ("wpA.csv" if idx == 0 else "wpB.csv")),
            [((base + 3, 250_000_000), 7, False), ((base + 12, 250_000_000), 8, idx == 1)])
    tio.write_poses_with_timestamps(str(root / "odom" / "bagA.csv"),
                                    [((100 + i, 250_000_000), b) for i, b in enumerate(bl)])
    write_extrinsics(root / "calib" / "orb_slam3_bl.txt", ext)
    write_extrinsics(root / "calib" / "lego_loam_bl.txt", gt_ext)
    return root


def copy_estimates(root):
    """The script writes traj_with_waypoints.csv next to the estimates:
    each package gets its own copy."""
    return lambda out: shutil.copytree(root / "est", out / "est")


APPROACH_CASES = {
    "sequence_odometry": lambda r: [
        "--sequence_file", str(r / "seq.json"), "--odometry_files_directory", str(r / "odom"),
        "--comparison_alg_to_bl_extrinsics", str(r / "calib" / "orb_slam3_bl.txt"),
        "--gt_frame_to_bl_extrinsics", str(r / "calib" / "lego_loam_bl.txt"),
        "--waypoints_files_directory", str(r / "wps")],
    "sequence": lambda r: ["--sequence_file", str(r / "seq.json"),
                           "--waypoints_files_directory", str(r / "wps")],
    "tum": lambda r: ["--sequence_file", str(r / "seq.json"), "--traj_format", "tum",
                      "--est_traj_file_name", "trajectory.txt"],
    "nolost": lambda r: ["--sequence_file", str(r / "seq.json"),
                         "--traj_format", "timestamped_nolost",
                         "--est_traj_file_name", "nolost.csv"],
    "single": lambda r: ["--single_trajectory_eval_base_name", "0_bagA"],
    "no_mode": lambda r: [],
}


@pytest.mark.parametrize("case", list(APPROACH_CASES))
def test_compute_metrics_for_approach(approach, tmp_path, case):
    (code, out, _), d = run_both(
        "compute_metrics_for_approach",
        lambda o: ["--comparison_alg_traj_est_dir", str(o / "est"),
                   "--interpolated_gt_traj_dir", str(approach / "gt"),
                   "--metrics_out_file", str(o / "metrics.json")]
        + APPROACH_CASES[case](approach),
        tmp_path, prepare=copy_estimates(approach))
    assert code == (1 if case == "no_mode" else 0)
    if code == 0:
        seq, indiv = schema.read_metrics_file(str(d / "metrics.json"))
        assert len(indiv) == (1 if case == "single" else 2)
        assert 0 < seq["ate"].rmse_transl_err < 0.2


@pytest.mark.parametrize("name,root_flag,est_file", [
    ("compute_metrics_for_orbslam3", "--orb_slam_3_out_root_dir", "trajectory.txt"),
    ("compute_metrics_for_droidslam", "--droid_slam_out_root_dir", "trajectory.txt"),
    ("compute_metrics_for_oaslam", "--oa_slam_out_root_dir", "trajectory.csv"),
])
def test_compute_metrics_for_baselines(approach, tmp_path, name, root_flag, est_file):
    """The baseline wrappers: their calibration file names and formats,
    through the port's compute_metrics_for_approach."""
    (code, _, _), d = run_both(
        name,
        lambda o: ["--sequence_file", str(approach / "seq.json"), root_flag, str(o / "est"),
                   "--interpolated_gt_traj_dir", str(approach / "gt"),
                   "--calibration_file_directory", str(approach / "calib"),
                   "--waypoints_files_directory", str(approach / "wps"),
                   "--metrics_out_file", str(o / "metrics.json"),
                   "--est_traj_file_name", est_file],
        tmp_path, prepare=copy_estimates(approach))
    assert code == 0 and (d / "est" / "0_bagA" / "traj_with_waypoints.csv").exists()


def write_node_poses(path, poses):
    with open(path, "w") as f:
        f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for i, p in enumerate(poses):
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{i}," + ",".join(str(v) for v in [*p[:3], *q]) + "\n")


def write_objects(path, objects):
    with open(path, "w") as f:
        f.write("semantic_class,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w,"
                "d_x,d_y,d_z,obj_id\n")
        for k, e in enumerate(objects):
            q = Rotation.from_euler("z", e[3]).as_quat()
            f.write("chair," + ",".join(str(v) for v in [*e[:3], *q, *e[4:]]) + f",{k}\n")


@pytest.mark.parametrize("plots", [False, True], ids=["metrics", "plots"])
def test_compute_metrics_for_sequence(tmp_path, plots):
    """Per-session ATE/RPE, waypoint consistency and object metrics over
    two sessions, the reference schema file, and (``--plots_dir``) the
    waypoint CDFs and top-down plots."""
    rng = np.random.default_rng(31)
    bl = base_link_path(rng, 12)
    sessions = []
    for s in range(2):
        est = [np.r_[p[:3] + rng.normal(scale=0.05, size=3), p[3:]] for p in bl]
        write_node_poses(tmp_path / f"est{s}.csv", est)
        write_node_poses(tmp_path / f"gt{s}.csv", bl)
        (tmp_path / f"wp{s}.json").write_text(json.dumps({"7": [2, 3], "8": [9, 40]}))
        gt_objects = np.c_[rng.uniform(-3, 3, (3, 3)), rng.uniform(-1, 1, 3),
                           rng.uniform(0.4, 1, (3, 3))]
        write_objects(tmp_path / f"gt_obj{s}.csv", gt_objects)
        write_objects(tmp_path / f"est_obj{s}.csv",
                      gt_objects + rng.normal(scale=0.05, size=gt_objects.shape))
        sessions.append(dict(name=f"s{s}", est_trajectory_file=str(tmp_path / f"est{s}.csv"),
                             gt_trajectory_file=str(tmp_path / f"gt{s}.csv"),
                             waypoints_file=str(tmp_path / f"wp{s}.json"),
                             est_objects_file=str(tmp_path / f"est_obj{s}.csv"),
                             gt_objects_file=str(tmp_path / f"gt_obj{s}.csv")))
    (tmp_path / "sessions.json").write_text(json.dumps(sessions))
    (code, out, _), d = run_both(
        "compute_metrics_for_sequence",
        lambda o: ["--sequence_results_file", str(tmp_path / "sessions.json"),
                   "--metrics_out_file", str(o / "metrics.json"),
                   "--ref_schema_out_file", str(o / "ref.json")]
        + (["--plots_dir", str(o / "plots")] if plots else []),
        tmp_path / "runs")
    assert code == 0 and "sequence ATE" in out
    if plots:
        assert sorted(os.listdir(d / "plots")) == [
            "s0_topdown.png", "s1_topdown.png", "waypoint_cdfs.png"]


def test_timing_analysis(tmp_path):
    rng = np.random.default_rng(32)
    paths = []
    for k in range(2):
        timers = {name: {"total_s": float(rng.uniform(0, 50)),
                         "invocations": int(rng.integers(0, 30))}
                  for name in ("offline_runner_online_portion", "local_bundle_adjustment",
                               "frame_data_adder", "ltm_extraction")[: 3 + k]}
        paths.append(str(tmp_path / f"timing{k}.json"))
        with open(paths[-1], "w") as f:
            json.dump(timers, f)
    (code, out, _), _ = run_both("timing_analysis", lambda o: paths, tmp_path / "runs")
    assert code == 0 and "online portion" in out


# ---- the one-session estimator -------------------------------------------------


def step_name(cmd0):
    """A step's entry point: the JAX script's file name or the port's
    module."""
    return str(cmd0).rsplit("/", 1)[-1].removesuffix(".py").rsplit(".", 1)[-1]


def test_single_trajectory_estimator_runs_the_jax_steps(monkeypatch, tmp_path):
    """Every option on: the port runs the JAX script's steps, each the
    port's module of the same name with the JAX step's flags (``--platform``
    as ``--device``), in the same order."""
    steps = {}
    common = ["--params_config_file", "c.json", "--intrinsics_file", "i.csv",
              "--extrinsics_file", "e.csv", "--orb_out_dir", str(tmp_path / "orb"),
              "--raw_orb_matches_dir", "raw", "--raw_data_path", "rd", "--calibration_path", "cal",
              "--bounding_boxes_by_node_id_file", "bb.csv", "--long_term_map_input", "ltm.json",
              "--output_dir", str(tmp_path / "out"), "--sparsify",
              "--max_pose_inc_threshold_transl", "0.3", "--max_pose_inc_threshold_rot", "0.05"]
    for label, flag in (("jax", "--platform"), ("port", "--device")):
        module = jax_cli("single_trajectory_estimator") if label == "jax" else port_cli(
            "single_trajectory_estimator")
        recorded = []
        monkeypatch.setattr(module, "run", recorded.append)
        assert module.main(common + [flag, "cpu"]) == 0
        steps[label] = [[step_name(c[0])] + ["--device" if str(a) == "--platform" else str(a)
                                             for a in c[1:]] for c in recorded]
    assert steps["jax"] == steps["port"]
    assert [s[0] for s in steps["port"]] == [
        "orb_stereo_reformat_data", "initialize_traj_and_feats_from_orb_out",
        "orb_trajectory_sparsifier", "offline_object_visual_slam_main"]


def test_single_trajectory_estimator_in_a_fresh_interpreter(tmp_path):
    """``python -m`` the estimator with ``--sparsify --device cpu`` on an
    exported visual session: it runs the port's sparsifier and main entry
    point, and every output reads back."""
    from test_torch_runner import small_config

    data, gt, _ = ot.synthetic_session(n_frames=10, n_features=30)
    d = ot.synthetic.export_session_files(data, gt, tmp_path / "files")
    (d / "orb_out" / "poses").mkdir()
    shutil.copy(d / "poses.csv", d / "orb_out" / "poses" / "initial_robot_poses_by_node.txt")
    ot.config.write_config(small_config(ot.config), str(d / "config.json"))
    out = tmp_path / "out"
    run = subprocess.run(
        [sys.executable, "-m", "obvi_slam_tpu_torch.cli.single_trajectory_estimator",
         "--params_config_file", str(d / "config.json"),
         "--intrinsics_file", str(d / "intrinsics.csv"),
         "--extrinsics_file", str(d / "extrinsics.csv"), "--orb_out_dir", str(d / "orb_out"),
         "--output_dir", str(out), "--sparsify", "--max_pose_inc_threshold_transl", "0.3",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))
    assert run.returncode == 0, run.stderr[-3000:]
    sparse = ot.io.read_poses_by_node_id(str(out / "sparsified_poses.csv"))
    poses = ot.io.read_poses_by_node_id(str(out / "robot_poses.csv"))
    assert 3 <= len(poses) == len(sparse) < 10
    ot.LongTermObjectMap.load(str(out / "long_term_map.json"))
    assert "offline_runner_online_portion" in json.loads((out / "timing.json").read_text())
    assert len((out / "ceres_opt_summary.csv").read_text().splitlines()) > 1


# ---- the comparison launchers ----------------------------------------------------


@pytest.fixture()
def sequence(tmp_path):
    path = tmp_path / "sequence.json"
    path.write_text(json.dumps([{"name": "bagA"}, {"name": "bagB", "session_input": "/in/B"},
                                "bagC"]))
    return path


def test_run_orb_slam_2_dry_run(sequence, tmp_path):
    (_, out, _), _ = run_both(
        "run_orb_slam_2",
        lambda o: ["--orb_slam_vocabulary_file", "/v/voc.txt",
                   "--orb_slam_configuration_file", "/c/stereo.yaml",
                   "--sequence_file", str(sequence), "--orb_slam_2_out_root_dir", str(o / "out"),
                   "--session_input_root", "/bags", "--dry_run"], tmp_path / "runs")
    assert out.count("ORB_SLAM2_Stereo /v/voc.txt /c/stereo.yaml false") == 3


def test_run_multi_session_orb_slam_3_map_chaining(sequence, tmp_path):
    (_, out, _), _ = run_both(
        "run_multi_session_orb_slam_3",
        lambda o: ["--orb_slam_vocabulary_file", "/v/voc.txt",
                   "--orb_slam_configuration_file", "/c/stereo.yaml",
                   "--sequence_file", str(sequence), "--orb_slam_3_out_root_dir", str(o / "out"),
                   "--dry_run"], tmp_path / "runs")
    assert "<out>/out/0_bagA/map.bin" in out.splitlines()[1]


def test_run_lego_loam_skip_and_force_rerun(sequence, tmp_path):
    """A session whose results look legitimate is skipped unless forced;
    the text list format of the sequence file."""
    names = tmp_path / "names.txt"
    names.write_text("# bags\nbagA\nbagB\n")

    def prepare(o):
        sdir = o / "out" / "0_bagA"
        sdir.mkdir(parents=True)
        (sdir / "trajectory.csv").write_text("node_id\n")
        (sdir / "extra.txt").write_text("x\n")

    for extra in ([], ["--force_rerun"]):
        (_, out, _), _ = run_both(
            "run_lego_loam",
            lambda o: ["--sequence_file", str(names), "--lego_loam_out_root_dir",
                       str(o / "out"), "--dry_run", *extra],
            tmp_path / f"runs{len(extra)}", prepare=prepare)
        assert ("skipping bagA" in out) == (not extra)


def test_run_comparison_system_executes(sequence, tmp_path):
    """A real run with a stand-in binary: each session's directory gets
    what the command wrote; a failing command stops the sequence with its
    exit code."""
    (code, _, _), d = run_both(
        "run_comparison_system",
        lambda o: ["--system_name", "fake", "--sequence_file", str(sequence),
                   "--results_root_dir", str(o / "out"), "--multi_session_map",
                   "--command_template", "touch {output_dir}/ran_{name}_{index}"],
        tmp_path / "runs")
    assert code == 0 and (d / "out" / "2_bagC" / "ran_bagC_2").exists()
    (code, _, err), _ = run_both(
        "run_comparison_system",
        lambda o: ["--system_name", "fake", "--sequence_file", str(sequence),
                   "--results_root_dir", str(o / "out"),
                   "--command_template", f"{sys.executable} -c 'import sys; sys.exit(3)'"],
        tmp_path / "failing")
    assert code == 3 and "FAILED" in err
