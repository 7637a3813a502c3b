"""The bounding-box frontend on 2 gloo ranks on the CPU at f64: rank 1's
pending-object mini-BA results are perturbed on purpose, and rank 0's
estimates (with the flags derived from them) must replace them on every
rank, so that the ranks end bit for bit equal and equal to the unperturbed
run; the witness shows that without the broadcast the same
perturbation leaves the ranks apart. Once for the frontend alone on the
ground-truth poses, once for the main CLI's session with ``--shard_devices
2`` (global BA sharded, every other solve agreed through the runner)."""

import numpy as np
import pytest
import torch

import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli
from torch_cli_helpers import input_args
from torch_mp import run_ranks
from torch_mp_worker import frontend_run
from torch_object_helpers import ASYM_DIMS, object_config

torch.set_num_threads(1)

# Added to every object of rank 1's mini-BA results: far above roundoff,
# small enough that an unagreed rank still makes rank 0's decisions.
PERTURB = 1e-3
FRONTEND_SESSION = dict(n_frames=14)
# Asymmetric chairs: with dx = dy the session's LM is chaotic in the yaw
# (ROADMAP Queue 3), and the sharded sums' roundoff would grow past any
# tolerance against one process.
CLI_SESSION = dict(n_frames=8, dims=ASYM_DIMS)


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("config") / "objects.json"
    ot.config.write_config(object_config(ot.config), str(path))
    return str(path)


def _frontend_inputs(config_path, agree):
    return dict(session=FRONTEND_SESSION, config=config_path, perturb=PERTURB, agree=agree)


@pytest.fixture(scope="module")
def frontend_ranks(config_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("frontend")
    torch.save(_frontend_inputs(config_path, True), out / "inputs.pt")
    return run_ranks("frontend", 2, out, timeout=150)


def _assert_same_frontend(a, b):
    assert a["objects"].keys() == b["objects"].keys()
    for k in a["objects"]:
        assert np.array_equal(a["objects"][k], b["objects"][k]), k
    assert a["observations"] == b["observations"]
    assert len(a["pending"]) == len(b["pending"])
    for x, y in zip(a["pending"], b["pending"]):
        assert (x is None and y is None) or np.array_equal(x, y)


def test_frontend_ranks_take_rank0_estimates(frontend_ranks, config_path):
    """Rank 1's perturbed estimates are replaced by rank 0's: both ranks end
    with the single-process run's objects, observations and pending
    estimates, bit for bit, and only rank 1 saw a difference."""
    rank0, rank1 = frontend_ranks
    single = frontend_run(_frontend_inputs(config_path, True))
    assert single["objects"] and not single["differences"]
    _assert_same_frontend(rank0, rank1)
    _assert_same_frontend(rank0, single)
    assert len(rank0["differences"]) == len(rank1["differences"]) > 0
    assert max(rank0["differences"]) == 0.0
    assert PERTURB / 2 < max(rank1["differences"]) < 2 * PERTURB


def test_frontend_ranks_differ_without_broadcast(config_path, tmp_path):
    """The witness: the same perturbation with no mesh on the frontend
    leaves rank 1's objects apart from rank 0's."""
    torch.save(_frontend_inputs(config_path, False), tmp_path / "inputs.pt")
    rank0, rank1 = run_ranks("frontend", 2, tmp_path, timeout=150)
    assert not rank0["differences"] and not rank1["differences"]
    assert rank0["objects"].keys() == rank1["objects"].keys() and rank0["objects"]
    gap = max(np.max(np.abs(rank0["objects"][k] - rank1["objects"][k]))
              for k in rank0["objects"])
    assert gap > PERTURB / 2


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    data, gt, _ = ot.synthetic_object_session(**CLI_SESSION)
    d = ot.synthetic.export_session_files(data, gt, tmp_path_factory.mktemp("cli"))
    ot.config.write_config(object_config(ot.config, ASYM_DIMS), str(d / "config.json"))
    return d


def _cli_ranks(files, out, perturb):
    argv = input_args(files) + ["--device", "cpu", "--f64", "--shard_devices", "2"]
    out.mkdir()
    torch.save(dict(argv=argv, perturb=perturb), out / "inputs.pt")
    return run_ranks("frontend_session", 2, out, timeout=200)


def test_cli_session_ranks_take_rank0_estimates(cli_files, tmp_path):
    """The main CLI's session on 2 ranks (``--shard_devices 2 --device
    cpu``), rank 1's mini-BAs perturbed: the ranks' pose graphs, pending
    estimates and solve logs equal each other and the unperturbed 2-rank
    run's, bit for bit. Against the single-process session (whose sums
    round otherwise than the sharded global BA's, a difference that a
    chained object session grows past the 1e-7 that holds for visual
    sessions: ROADMAP Queue 3) the schedule and the associations are the
    same and the trajectory within 5e-3 m."""
    perturbed = _cli_ranks(cli_files, tmp_path / "perturbed", PERTURB)
    unperturbed = _cli_ranks(cli_files, tmp_path / "unperturbed", 0.0)
    rank0 = unperturbed[0]
    for r in perturbed + unperturbed[1:]:
        assert r["state"] == rank0["state"]
        assert r["opt_log"] == rank0["opt_log"]
        assert all(np.array_equal(a, b) for a, b in zip(r["pending"], rank0["pending"]))
    assert rank0["state"]["objects"]
    assert max(perturbed[0]["differences"]) == 0.0
    assert max(perturbed[1]["differences"]) > PERTURB / 2

    session = main_cli.build_session(main_cli.parse_args(
        input_args(cli_files) + ["--device", "cpu", "--f64"]))
    assert main_cli.run_session(session)
    single = session.pg.get_state()
    assert not session.bb_frontend.rank_differences
    assert [(r.frame_id, r.phase) for r in session.runner.opt_log] == [
        x[:2] for x in rank0["opt_log"]]
    assert single["objects"].keys() == rank0["state"]["objects"].keys()
    assert [o[:3] for o in single["object_observations"]] == [
        o[:3] for o in rank0["state"]["object_observations"]]
    for k, v in single["robot_poses"].items():
        np.testing.assert_allclose(rank0["state"]["robot_poses"][k][:3], v[:3], atol=5e-3)
