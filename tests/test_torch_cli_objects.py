"""The port's entry points on object sessions against the JAX package at f64
on the CPU: the main CLI on the exported asymmetric-chair session against
the JAX session on the same files (wired as the JAX CLI wires it, every
solve recorded and replayed through the port: torch_object_helpers says
why a chained object session is held to schedule, replays and gates rather
than to values), the reference CLI tests' gates through the port's metrics
CLIs, the LTM JSON across packages, and the LTM-only CLI against the JAX
extraction."""

import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import ltm as jltm
from obvi_slam_tpu.io.readers import make_cameras as jax_make_cameras
from obvi_slam_tpu import io as jio
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch.cli import ltm_extraction_only as ltm_cli
from obvi_slam_tpu_torch.cli import object_metrics_generator as object_metrics_cli
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli
from obvi_slam_tpu_torch.cli import trajectory_metrics_generator as trajectory_metrics_cli
from obvi_slam_tpu_torch.io import read_bb_association_results
from torch_cli_helpers import (
    CHECKPOINTS,
    checkpoint_names,
    cli_args,
    csv_rows,
    export,
    jax_files_session,
)
from torch_object_helpers import ASYM_DIMS, SolveRecorder, assert_replays_match, object_config

torch.set_num_threads(1)

# The opt log's schedule columns: frame, global BA, phase, attempt, poses,
# objects (the features admitted may differ: see torch_object_helpers).
SCHEDULE = (0, 1, 2, 3, 4, 6)


def write_gt_objects(path, gt_objects):
    """Ground-truth chairs in the ellipsoid results' format."""
    with open(path, "w") as f:
        f.write("semantic_class,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w,"
                "d_x,d_y,d_z,obj_id\n")
        for k, e in enumerate(gt_objects):
            q = Rotation.from_euler("z", e[3]).as_quat()
            f.write(f"chair,{e[0]},{e[1]},{e[2]},{q[0]},{q[1]},{q[2]},{q[3]},"
                    f"{e[4]},{e[5]},{e[6]},{k}\n")


@pytest.fixture(scope="module")
def objects(tmp_path_factory):
    root = tmp_path_factory.mktemp("objects")
    data, gt, gt_objects = ot.synthetic_object_session(dims=ASYM_DIMS)
    d = export(data, gt, root / "files", object_config(jcfg, ASYM_DIMS))
    write_gt_objects(d / "gt_objects.csv", gt_objects)
    rc = main_cli.main(cli_args(d, root / "ours"))
    runner, pg, recorder = jax_files_session(d, root / "ref", SolveRecorder)
    return dict(rc=rc, d=d, ours=root / "ours", ref=root / "ref", jax_runner=runner,
                jax_pg=pg, records=recorder.records, root=root)


def test_object_cli_same_schedule_and_associations(objects):
    assert objects["rc"] == 0
    (_, ours), (_, ref) = (csv_rows(objects[k] / "ceres_opt_summary.csv") for k in ("ours", "ref"))
    assert [[r[i] for i in SCHEDULE] for r in ours] == [[r[i] for i in SCHEDULE] for r in ref]
    assert {r[2] for r in ours} == {"1", "2"}
    (e_ours, a_ours), (e_ref, a_ref) = (
        read_bb_association_results(str(objects[k] / "bb_assoc.json")) for k in ("ours", "ref"))
    assert e_ours.keys() == e_ref.keys() and len(e_ours) == 2
    assert {o: [(f, c) for f, c, _ in obs] for o, obs in a_ours.items()} == {
        o: [(f, c) for f, c, _ in obs] for o, obs in a_ref.items()}


def test_object_cli_jax_solves_replay_equal(objects):
    """Every window BA and mini-BA of the JAX session, replayed through the
    port's solver on its inputs."""
    assert {r[0] for r in objects["records"]} == {"solve", "two_phase"}
    assert_replays_match(objects["records"])


@pytest.mark.parametrize("which", ["ours", "ref"])
def test_object_cli_meets_the_reference_gates(objects, which):
    """tests/test_cli.py::TestMainCli::test_full_session's gates, through the
    port's metrics CLIs, on the port CLI's outputs and on the JAX session's."""
    out, d = objects[which], objects["d"]
    assert trajectory_metrics_cli.main([
        "--est_trajectory_file", str(out / "robot_poses.csv"),
        "--gt_trajectory_file", str(d / "gt_poses.csv"),
        "--metrics_out_file", str(out / "traj_metrics.json")]) == 0
    metrics = json.loads((out / "traj_metrics.json").read_text())
    assert metrics["rmse_transl_err"] < 0.05 and metrics["lost_poses"] == 0, metrics
    assert object_metrics_cli.main([
        "--est_objects_file", str(out / "ellipsoids.csv"),
        "--gt_objects_file", str(d / "gt_objects.csv"),
        "--metrics_out_file", str(out / "obj_metrics.json")]) == 0
    om = json.loads((out / "obj_metrics.json").read_text())
    assert om["recall"] == 1.0 and om["average_pos_deviation"] < 0.5 and om["avg_iou"] > 0.3, om
    assert len(json.loads((out / "ltm.json").read_text())["ellipsoids"]) == 2
    assert len(read_bb_association_results(str(out / "bb_assoc.json"))[0]) == 2
    assert "global_bundle_adjustment" in json.loads((out / "timing.json").read_text())
    names = checkpoint_names(out)
    assert all(c in names for c in CHECKPOINTS)
    assert any(n.startswith("pose_graph_state_checkpoint_pre_optimization_")
               and n.endswith("_attempt_1.json") for n in names)


def test_object_cli_ltm_loads_across_packages(objects):
    ours = jltm.LongTermObjectMap.load(str(objects["ours"] / "ltm.json"))
    ref = ot.LongTermObjectMap.load(str(objects["ref"] / "ltm.json"))
    assert ours.ellipsoids.keys() == ref.ellipsoids.keys() and len(ours.covariances) == 2
    for ltm in (ours, ref):
        for cov in ltm.covariances.values():
            w = np.linalg.eigvalsh(0.5 * (cov + cov.T))
            assert np.all(np.isfinite(cov)) and w.min() >= -1e-12 * w.max()


def test_object_cli_iteration_csvs(objects):
    """The per-iteration CSVs of every solve type the session runs: the
    window BAs' and the mini-BAs', with the reference header."""
    for which in ("ours", "ref"):
        names = {p.name for p in (objects[which] / "logs").glob("ceres_iterations_*.csv")}
        assert {f"ceres_iterations_{t}.csv" for t in (
            "pending_obj_est", "lba_phase_1", "lba_phase_2", "gba_phase_1", "gba_phase_2")
        } <= names, (which, names)
    header, rows = csv_rows(objects["ours"] / "logs" / "ceres_iterations_pending_obj_est.csv")
    assert header == ("optimization_id,iteration_num,cost,cost_change,step_norm,"
                      "step_norm_per_param,is_successful")
    assert rows and all(len(r) == 7 and r[6] in ("0", "1") for r in rows)


def test_ltm_extraction_only_matches_jax(objects, tmp_path):
    """The port's LTM-only CLI and the JAX extraction on the JAX session's
    long_term_map_checkpoint.json: the same objects, covariances within 1e-8
    of each block's largest entry; TF32 left off. The config adds the
    odometry factors of every frame to the extraction problem (the
    monocular session's scale gauge, as tests/test_torch_ltm.py and
    tests/test_ltm.py force it)."""
    d, ckpt = objects["d"], objects["ref"] / "checkpoints" / "long_term_map_checkpoint.json"
    config = object_config(jcfg, ASYM_DIMS)
    config.optimization_factors_enabled_params.min_low_level_feature_observations_per_frame = (
        10**9)
    jcfg.write_config(config, str(tmp_path / "config.json"))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rc = ltm_cli.main([
            "--input_checkpoint_file", str(ckpt),
            "--params_config_file", str(tmp_path / "config.json"),
            "--intrinsics_file", str(d / "intrinsics.csv"),
            "--extrinsics_file", str(d / "extrinsics.csv"),
            "--long_term_map_output", str(tmp_path / "ltm.json"), "--device", "cpu"])
        tf32 = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert rc == 0 and tf32 is False
    ours = ot.LongTermObjectMap.load(str(tmp_path / "ltm.json"))
    config = jcfg.read_config(str(tmp_path / "config.json"))
    cameras, _ = jax_make_cameras(jio.read_camera_intrinsics(str(d / "intrinsics.csv")),
                                  jio.read_camera_extrinsics(str(d / "extrinsics.csv")))
    pg = JaxPoseGraph.from_state(json.loads(ckpt.read_text()), cameras,
                                 jcfg.shape_prior_map(config))
    ref = jltm.extract_long_term_object_map(pg, config, {})
    assert sorted(ours.covariances) == sorted(ref.covariances) == sorted(pg.objects)
    for o, cov in ref.covariances.items():
        err = np.abs(ours.covariances[o] - cov).max() / np.abs(cov).max()
        assert err <= 1e-8, (o, err)
    assert {o: e[0] for o, e in ours.ellipsoids.items()} == {
        o: e[0] for o, e in ref.ellipsoids.items()}
