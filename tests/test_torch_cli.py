"""The port's entry points on a visual session against the JAX package at
f64 on the CPU: the main CLI on the exported 8-frame session of
tests/test_torch_runner.py (no detections file) against the JAX session on
the same files wired as the JAX CLI wires it; the runner's host-loop
two-phase branch against JAX's and against the port's fused branch; the
resume CLI against the JAX runner resumed in process; full-precision
matmuls after each entry point."""

import json

import numpy as np
import pytest
import torch

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import runner as jrunner
from obvi_slam_tpu.frontend import VisualFeatureFrontend as JaxVisualFrontend
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import runner as prunner
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli
from obvi_slam_tpu_torch.cli import run_opt_from_pg_state as resume_cli
from obvi_slam_tpu_torch.io.readers import read_poses_by_node_id
from obvi_slam_tpu_torch.pose_graph import OBJECT_OBSERVATION_FACTOR, REPROJECTION_FACTOR
from obvi_slam_tpu_torch.solver import two_phase as tp_mod
from test_runner_e2e import make_session
from test_torch_runner import SESSION, small_config
from torch_cli_helpers import (
    CHECKPOINTS,
    checkpoint_names,
    cli_args,
    csv_floats,
    csv_rows,
    export,
    input_args,
    iteration_csvs,
    jax_files_session,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-9
# The opt log's schedule columns: frame, global BA, phase, attempt, poses,
# features, objects.
SCHEDULE = slice(0, 7)
FINAL_COST = 8


def full_precision():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture(scope="module")
def visual(tmp_path_factory):
    """The port CLI and the JAX session on the exported visual session, with
    TF32 switched on before the CLI runs (the CLI must switch it off)."""
    root = tmp_path_factory.mktemp("visual")
    data, gt, _ = ot.synthetic_session(**SESSION)
    d = export(data, gt, root / "files", small_config(), detections=False)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        rc = main_cli.main(cli_args(d, root / "ours"))
        precision = full_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    runner, pg, _ = jax_files_session(d, root / "ref")
    return dict(rc=rc, precision=precision, d=d, ours=root / "ours", ref=root / "ref",
                gt=gt, jax_runner=runner)


def test_visual_cli_results_match_jax(visual):
    assert visual["rc"] == 0
    for name in ("robot_poses.csv", "features.csv"):
        h_ours, rows_ours = csv_rows(visual["ours"] / name)
        h_ref, rows_ref = csv_rows(visual["ref"] / name)
        assert h_ours == h_ref and [r[0] for r in rows_ours] == [r[0] for r in rows_ref]
        np.testing.assert_allclose(csv_floats(visual["ours"] / name),
                                   csv_floats(visual["ref"] / name), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    poses = read_poses_by_node_id(str(visual["ours"] / "robot_poses.csv"))
    ate = np.sqrt(np.mean([np.sum((poses[i][:3] - visual["gt"][i, :3]) ** 2) for i in poses]))
    assert ate < 0.05, ate


def test_visual_cli_opt_log_matches_jax(visual):
    """The per-solve log: the same schedule and final costs."""
    h_ours, rows_ours = csv_rows(visual["ours"] / "ceres_opt_summary.csv")
    h_ref, rows_ref = csv_rows(visual["ref"] / "ceres_opt_summary.csv")
    assert h_ours == h_ref == main_cli.OPT_LOG_HEADER
    assert len(rows_ours) == len(rows_ref) > 2
    assert [r[SCHEDULE] for r in rows_ours] == [r[SCHEDULE] for r in rows_ref]
    assert [r[-1] for r in rows_ours] == [r[-1] for r in rows_ref]
    np.testing.assert_allclose(csv_floats(visual["ours"] / "ceres_opt_summary.csv", FINAL_COST),
                               csv_floats(visual["ref"] / "ceres_opt_summary.csv", FINAL_COST),
                               rtol=RTOL, atol=1e-20)


def test_visual_cli_iteration_csvs_match_jax(visual):
    """ceres_iterations_<type>.csv: the same types, the same (optimization
    id, iteration, success) rows, costs within RTOL."""
    ours, ref = iteration_csvs(visual["ours"] / "logs"), iteration_csvs(visual["ref"] / "logs")
    assert ours.keys() == ref.keys() and {"ceres_iterations_gba_phase_1.csv",
                                          "ceres_iterations_gba_phase_2.csv"} <= ours.keys()
    for name in ref:
        (h_ours, rows_ours), (h_ref, rows_ref) = ours[name], ref[name]
        assert h_ours == h_ref
        key = [(r[0], r[1], r[6]) for r in rows_ours]
        assert key == [(r[0], r[1], r[6]) for r in rows_ref], name
        np.testing.assert_allclose([float(r[2]) for r in rows_ours],
                                   [float(r[2]) for r in rows_ref], rtol=RTOL, atol=1e-20,
                                   err_msg=name)


def test_visual_cli_writes_every_artifact(visual):
    ours = visual["ours"]
    names = checkpoint_names(ours)
    assert all(c in names for c in CHECKPOINTS)
    assert any(n.startswith("pose_graph_state_checkpoint_pre_optimization_")
               and n.endswith("_attempt_1.json") for n in names)
    assert names == checkpoint_names(visual["ref"])
    timing = json.loads((ours / "timing.json").read_text())
    assert {"global_bundle_adjustment", "ltm_extraction", "frame_data_adder"} <= timing.keys()
    ltm = ot.LongTermObjectMap.load(str(ours / "ltm.json"))
    assert ltm.ellipsoids == {}
    assert (ours / "logs" / "obvi_slam_tpu.log").exists()


def test_main_leaves_tf32_off(visual):
    assert visual["precision"] == (False, False, "highest")


# ---- the host-loop two-phase branch ----------------------------------------


def _exclusions(problem, masks):
    """Excluded (factor type, id) of the fused branch's outlier masks."""
    out = set()
    for ftype, rows, mask in ((REPROJECTION_FACTOR, problem.reproj_rows, masks[0]),
                              (OBJECT_OBSERVATION_FACTOR, problem.bbox_rows, masks[1])):
        out.update((ftype, int(rows[i])) for i in np.nonzero(mask.numpy())[0] if i < len(rows))
    return out


def _record_host_exclusions(monkeypatch, module, into):
    inner = module.reweight_for_exclusions

    def spy(pg, problem, excluded):
        into.append(set(excluded))
        return inner(pg, problem, excluded)

    monkeypatch.setattr(module, "reweight_for_exclusions", spy)


@pytest.fixture(scope="module")
def host_loop():
    """The 8-frame session through the port's host branch, JAX's host branch
    and the port's fused branch, each window's exclusion set recorded."""
    mp = pytest.MonkeyPatch()
    try:
        runs = {}
        data, _, _ = make_session(**SESSION)
        excl = []
        _record_host_exclusions(mp, jrunner, excl)
        jax_runner = jrunner.OfflineProblemRunner(
            small_config(), use_fused_solver=False, use_device_sync=False)
        jax_pg = JaxPoseGraph(data.cameras)
        vp = jax_runner.config.visual_feature_params
        assert jax_runner.run_optimization(data, jax_pg, visual_frontend=JaxVisualFrontend(
            gba_checker=lambda f: jax_runner._gba_checker(f, data.max_frame_id()),
            reprojection_error_provider=lambda *a: vp.reprojection_error_std_dev,
            min_parallax_pixel=vp.min_visual_feature_parallax_pixel_requirement,
            inlier_epipolar_err_thresh=vp.inlier_epipolar_err_thresh,
            check_past_n_frames=vp.check_past_n_frames_for_epipolar_err))
        runs["jax"] = (jax_runner, jax_pg, excl)
        for name, fused in (("host", False), ("fused", None)):
            excl, masks, problems = [], [], []
            if fused is False:
                _record_host_exclusions(mp, prunner, excl)
            else:
                inner_mask = tp_mod._outlier_mask
                mp.setattr(tp_mod, "_outlier_mask",
                           lambda *a: masks.append(inner_mask(*a)) or masks[-1])
            ours, _, _ = ot.synthetic_session(**SESSION)
            ot.timing.TimerRegistry.instance().reset()
            runner = ot.OfflineProblemRunner(small_config(ot.config), device="cpu",
                                             use_fused_solver=fused)
            inner_tp = runner._solve_two_phase
            runner._solve_two_phase = (
                lambda p, it, mesh=None: problems.append(p) or inner_tp(p, it, mesh))
            pg = ot.PoseGraph(ours.cameras)
            assert runner.run_optimization(ours, pg, visual_frontend=prunner.visual_frontend_for(
                runner, ours))
            if fused is None:
                assert len(masks) == 2 * len(problems)
                excl = [_exclusions(p, masks[2 * k:2 * k + 2]) for k, p in enumerate(problems)]
            else:
                assert not problems
            runs[name] = (runner, pg, excl, set(ot.timing.TimerRegistry.instance().timers))
        return runs
    finally:
        mp.undo()


def test_host_loop_exclusions_match_jax_and_fused(host_loop):
    """Per window, the port's host branch excludes what JAX's host branch
    and the port's fused branch exclude."""
    host, ref, fused = (host_loop[k][2] for k in ("host", "jax", "fused"))
    assert len(host) == len(ref) == len(fused) > 2
    assert any(host)
    assert host == ref
    assert host == fused


def test_host_loop_schedule_and_trajectory_match_jax(host_loop):
    (runner, pg, _, _), (jax_runner, jax_pg, _) = host_loop["host"], host_loop["jax"]
    key = lambda r: (r.frame_id, r.global_ba, r.phase, r.attempt, r.num_poses,  # noqa: E731
                     r.num_features, r.num_objects, r.termination)
    assert [key(r) for r in runner.opt_log] == [key(r) for r in jax_runner.opt_log]
    np.testing.assert_allclose([r.final_cost for r in runner.opt_log],
                               [r.final_cost for r in jax_runner.opt_log], rtol=RTOL,
                               atol=1e-20)
    n = pg.max_frame_id() + 1
    for other in (jax_pg, host_loop["fused"][1]):
        np.testing.assert_allclose(
            np.stack([pg.get_robot_pose(i) for i in range(n)]),
            np.stack([other.get_robot_pose(i) for i in range(n)]), rtol=RTOL, atol=ATOL)
    assert {"phase_one_gba_solve_opt", "phase_two_gba_build_opt",
            "phase_two_gba_solve_opt"} <= host_loop["host"][3]
    assert "phase_two_gba_solve_opt" not in host_loop["fused"][3]


# ---- the resume CLI ----------------------------------------------------------

RESUME_AT = 5


def test_resume_cli_matches_jax(tmp_path):
    """The port CLI's session cut at frame RESUME_AT - 1 (the config's
    trajectory limit) writes its pose-graph state; the port's resume CLI runs
    on from it at RESUME_AT over the whole session, and so does the JAX
    runner in process (wired as the JAX resume CLI wires it): trajectories
    within RTOL; TF32 left off."""
    data, gt, _ = ot.synthetic_session(**SESSION)
    cut = small_config()
    cut.limit_traj_eval_params.should_limit_trajectory_evaluation = True
    cut.limit_traj_eval_params.max_frame_id = RESUME_AT - 1
    d = export(data, gt, tmp_path / "cut", cut, detections=False)
    export(data, gt, tmp_path / "full", small_config(), detections=False)
    assert main_cli.main(input_args(d) + [
        "--device", "cpu", "--f64", "--checkpoint_output_dir", str(tmp_path / "ckpt")]) == 0
    state_file = tmp_path / "ckpt" / "pose_graph_state.json"
    state = json.loads(state_file.read_text())
    assert sorted(int(k) for k in state["robot_poses"]) == list(range(RESUME_AT))

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rc = resume_cli.main(input_args(tmp_path / "full") + [
            "--input_checkpoint_file", str(state_file), "--start_at_frame", str(RESUME_AT),
            "--run_data_adder_for_first_frame", "--device", "cpu", "--f64",
            "--robot_poses_results_file", str(tmp_path / "resumed.csv")])
        precision = full_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert rc == 0 and precision == (False, False, "highest")
    ours = read_poses_by_node_id(str(tmp_path / "resumed.csv"))

    config = jcfg.read_config(str(tmp_path / "full" / "config.json"))
    jdata = _files_data(tmp_path / "full")
    pg = JaxPoseGraph.from_state(state, jdata.cameras, jcfg.shape_prior_map(config))
    runner = jrunner.OfflineProblemRunner(config, use_fused_solver=True, use_device_sync=False)
    vf = JaxVisualFrontend(
        gba_checker=lambda f: runner._gba_checker(f, jdata.max_frame_id()),
        reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev)
    vf.added_feature_ids = set(pg.features)
    assert runner.run_optimization(jdata, pg, visual_frontend=vf, start_at_frame=RESUME_AT,
                                   add_data_for_starting_frame=True)
    assert sorted(ours) == pg.frame_ids() == list(range(SESSION["n_frames"]))
    np.testing.assert_allclose(np.stack([ours[i] for i in sorted(ours)]),
                               np.stack([pg.get_robot_pose(i) for i in sorted(ours)]),
                               rtol=RTOL, atol=ATOL)
    assert np.sqrt(np.mean([np.sum((ours[i][:3] - gt[i, :3]) ** 2) for i in ours])) < 0.05


def _files_data(d):
    """The JAX package's OfflineProblemData read from the files in ``d``."""
    from obvi_slam_tpu import io as jio
    from obvi_slam_tpu.io.readers import make_cameras
    from obvi_slam_tpu.offline_data import OfflineProblemData

    cameras, _ = make_cameras(jio.read_camera_intrinsics(str(d / "intrinsics.csv")),
                              jio.read_camera_extrinsics(str(d / "extrinsics.csv")))
    tracks, init = jio.read_orb_output_directory(str(d / "orb_out"))
    return OfflineProblemData(cameras=cameras, feature_tracks=tracks,
                              feature_init_positions=init,
                              initial_poses=jio.read_poses_by_node_id(str(d / "poses.csv")))


def test_detector_command_feeds_the_frontend(tmp_path):
    """--detector_command with --images_dir: frames without precomputed
    detections are asked of the detector worker (one query per image that
    exists) and its boxes reach the bounding-box frontend."""
    import sys
    import textwrap

    data, gt, _ = ot.synthetic_session(**SESSION)
    d = export(data, gt, tmp_path / "files", small_config(), detections=False)
    images = tmp_path / "images"
    (images / "1").mkdir(parents=True)
    for frame in (2, 3):
        (images / "1" / f"{frame}.png").write_bytes(b"")
    log = tmp_path / "queries.txt"
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""
        import json, sys
        for line in sys.stdin:
            req = json.loads(line)
            with open({str(log)!r}, "a") as f:
                f.write(f"{{req['frame_id']}} {{req['camera_id']}}\\n")
            print(json.dumps({{"detections": [
                {{"label": "chair", "conf": 0.9, "xyxy": [100, 80, 200, 300]}}]}}), flush=True)
    """))
    seen = []
    inner = ot.FeatureBasedBoundingBoxFrontEnd.add_bounding_box_observations

    def spy(self, frame_id, camera_id, bbs, observed):
        seen.append((frame_id, camera_id, len(bbs)))
        return inner(self, frame_id, camera_id, bbs, observed)

    mp = pytest.MonkeyPatch()
    mp.setattr(ot.FeatureBasedBoundingBoxFrontEnd, "add_bounding_box_observations", spy)
    try:
        assert main_cli.main(input_args(d) + [
            "--device", "cpu", "--f64", "--images_dir", str(images),
            "--detector_command", f"{sys.executable} {worker}"]) == 0
    finally:
        mp.undo()
    assert log.read_text().split("\n")[:-1] == ["2 1", "3 1"]
    assert seen == [(2, 1, 1), (3, 1, 1)]


def test_profile_trace_dir_writes_a_chrome_trace(tmp_path):
    data, gt, _ = ot.synthetic_session(**dict(SESSION, n_frames=4))
    d = export(data, gt, tmp_path / "files", small_config(), detections=False)
    assert main_cli.main(input_args(d) + [
        "--device", "cpu", "--f64", "--profile_trace_dir", str(tmp_path / "trace")]) == 0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
