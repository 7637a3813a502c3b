"""The runner and the main CLI of obvi_slam_tpu_torch on 2 gloo ranks on the
CPU, at f64: an 8-frame session (tests/test_torch_runner.py's small config)
with ``shard_local_ba`` off and on, against the single-process port and the
JAX package's runner on an 8-device mesh, ranks equal bit for bit and the
outputs written by rank 0 alone; ``--shard_devices 2 --device cpu`` through
the CLI; ``shard_sessions`` and ``initialize`` as the reference's."""

import os

import numpy as np
import pytest
import torch

import jax

import obvi_slam_tpu_torch as ot
from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import parallel as jpar
from obvi_slam_tpu import runner as jrunner
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu_torch import parallel as par
from obvi_slam_tpu_torch.runner import visual_frontend_for
from test_runner_e2e import make_session
from test_torch_runner import SESSION, _jax_frontend, small_config
from torch_mp import run_ranks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("config") / "small.json"
    jcfg.write_config(small_config(), str(path))
    return str(path)


def _poses(pg, n):
    return np.stack([pg.get_robot_pose(i) for i in range(n)])


@pytest.fixture(scope="module")
def single(config_path):
    data, _, _ = ot.synthetic_session(**SESSION)
    runner = ot.OfflineProblemRunner(ot.config.read_config(config_path), device="cpu")
    pg = ot.PoseGraph(data.cameras)
    assert runner.run_optimization(data, pg, visual_frontend=visual_frontend_for(runner, data))
    return _poses(pg, data.max_frame_id() + 1)


@pytest.fixture(scope="module", params=[False, True], ids=["global", "shard_local_ba"])
def sharded(request, config_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("runner")
    torch.save(dict(config=config_path, session=SESSION, shard_local_ba=request.param,
                    logs=str(out / "logs")), out / "inputs.pt")
    return request.param, out, run_ranks("runner", 2, out, timeout=150)


def jax_mesh_run(shard_local_ba):
    """The JAX runner on 8 virtual devices (its host loop, the CPU's
    default), presizing as the port's: (poses, (key, pool before the
    build) of every build)."""
    data, _, _ = make_session(**SESSION)
    config = small_config()
    runner = jrunner.OfflineProblemRunner(
        config, mesh=jpar.make_mesh(jax.devices()[:8]), shard_local_ba=shard_local_ba)
    pools = []
    build = runner.build_problem_synced

    def record(pg_, scope, key, **kw):
        pools.append((key, dict(runner.caps_pool(key))))
        return build(pg_, scope, key, **kw)

    runner.build_problem_synced = record
    pg = JaxPoseGraph(data.cameras)
    assert runner.run_optimization(data, pg, visual_frontend=_jax_frontend(runner, config, data))
    return _poses(pg, data.max_frame_id() + 1), pools


def test_sharded_runner_matches_single_process_and_jax(sharded, single):
    shard_local_ba, _, results = sharded
    poses = results[0]["poses"]
    assert np.array_equal(poses, results[1]["poses"])
    assert results[0]["opt_log"] == results[1]["opt_log"]
    np.testing.assert_allclose(poses, single, rtol=1e-7, atol=1e-9)
    # The reference's tolerance for its runner on a mesh against one device
    # (tests/test_runner_e2e.py::test_sharded_global_ba_matches_single_device).
    jax_poses, jax_pools = jax_mesh_run(shard_local_ba)
    np.testing.assert_allclose(poses, jax_poses, rtol=1e-7, atol=1e-9)
    # Both presize: every rank's pool at each build is the JAX runner's.
    assert results[0]["pools"] == results[1]["pools"] == jax_pools


def test_sharded_runner_writes_once(sharded):
    """Checkpoints and the per-iteration CSVs come from rank 0 alone."""
    _, out, results = sharded
    assert results[0]["checkpoints"] and not results[1]["checkpoints"]
    assert sorted(os.listdir(out / "logs" / "rank0"))
    assert not (out / "logs" / "rank1").exists() or not os.listdir(out / "logs" / "rank1")


def test_runner_mesh_needs_a_process_group():
    """A mesh that is not a parallel.Mesh, or whose process group is not
    initialized, raises; no path drops to the single-process solve."""
    c = small_config(ot.config)
    with pytest.raises(TypeError):
        ot.OfflineProblemRunner(c, device="cpu", mesh=object())
    with pytest.raises(RuntimeError):
        ot.OfflineProblemRunner(c, device="cpu", mesh=par.Mesh(2, 0, None, torch.device("cpu")))
    with pytest.raises(RuntimeError):
        par.make_mesh()


def test_cli_shard_devices_on_cpu(tmp_path, config_path):
    """--shard_devices 2 --device cpu runs two gloo ranks to the outputs,
    written once; the trajectory equals the single-process CLI's."""
    from obvi_slam_tpu_torch import io as pio
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli
    from obvi_slam_tpu_torch.synthetic import export_session_files

    data, gt, _ = ot.synthetic_session(**SESSION)
    d = export_session_files(data, gt, tmp_path / "in")
    inputs = ["--params_config_file", config_path, "--device", "cpu", "--f64"]
    for flag, name in (("--intrinsics_file", "intrinsics.csv"),
                       ("--extrinsics_file", "extrinsics.csv"),
                       ("--poses_by_node_id_file", "poses.csv"),
                       ("--low_level_feats_dir", "orb_out")):
        inputs += [flag, str(d / name)]
    runs = {}
    for label, extra in (("single", []), ("ranks", ["--shard_devices", "2", "--shard_local_ba"])):
        out = tmp_path / label
        out.mkdir()
        assert main_cli.main(inputs + extra + [
            "--robot_poses_results_file", str(out / "poses.csv"),
            "--opt_log_file", str(out / "opt_log.csv")]) == 0
        poses = pio.read_poses_by_node_id(str(out / "poses.csv"))
        runs[label] = np.stack([poses[i] for i in sorted(poses)])
        runs[label + "_log"] = (out / "opt_log.csv").read_text().splitlines()
    np.testing.assert_allclose(runs["ranks"], runs["single"], rtol=1e-7, atol=1e-9)
    assert len(runs["ranks_log"]) == len(runs["single_log"]) > 2


def test_cli_shard_devices_above_the_device_count(capsys):
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli

    argv = []
    for flag in ("--params_config_file", "--intrinsics_file", "--extrinsics_file",
                 "--poses_by_node_id_file", "--low_level_feats_dir"):
        argv += [flag, "unused"]
    n = (os.cpu_count() or 1) + 1
    with pytest.raises(SystemExit) as exit_info:
        main_cli.main(argv + ["--device", "cpu", "--shard_devices", str(n)])
    assert exit_info.value.code == (f"--shard_devices {n} exceeds the {n - 1} available cpu "
                                    "devices")


def test_shard_sessions_round_robin():
    """tests/test_metrics.py::TestDistributedHelpers, on the port."""
    from obvi_slam_tpu.parallel.distributed import shard_sessions as jax_shard_sessions

    sessions = [{"name": f"s{i}", "chain": i % 3} for i in range(9)]
    parts = [par.shard_sessions(sessions, p, 3) for p in range(3)]
    all_names = sorted(s["name"] for part in parts for s in part)
    assert all_names == sorted(s["name"] for s in sessions)
    for p, part in enumerate(parts):
        assert len({s["chain"] for s in part}) == 1
        assert part == jax_shard_sessions(sessions, p, 3)
    assert par.shard_sessions(sessions, 0, 1) == par.shard_sessions(sessions)  # one process
    assert sorted(s["name"] for s in par.shard_sessions(sessions)) == all_names


def test_initialize_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert par.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
