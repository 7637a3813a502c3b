"""Whole runs on the CPU at a small size, the harness's look for a chip
skipped: a sound run comes out correct, and a run whose timed path is
broken underneath comes out not correct, for each fault a one-chip cell
can have (a solve that returns its state unchanged, the window's or a
mini-BA's; half of the observations left out; an answer altered where it is
produced). The cells run on one chip, so there is no exchange between chips
to leave out."""

import io
import json

import pytest
import torch

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def small_files(cell):
    """The cell at a size the CPU runs in seconds. Its limits are the cell's,
    but for the first steps' norms: the CPU's host loop on windows of a few
    frames reads up to about 1e-2 there (the card's full-size windows read
    below 1e-5, PERF.md), so those are held at 1 here."""
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell}.json")
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{workload['config']}.json")
    for name in workload["limits"]:
        if name.startswith("first_step_norm"):
            workload["limits"][name] = 1.0
    if workload["driver"] == "gba":
        config.update(n_poses=48, n_points=256, n_objects=4)
        if "problem" in workload["traffic"]:
            workload["traffic"]["problem"]["n_poses"] = 40
        workload["reference"]["max_iterations"] = 40
        seconds = 10
    else:
        config.update(n_frames=16, n_features=150)
        config["port_config"]["sliding_window_params"] = {"local_ba_window_size": 6,
                                                          "global_ba_frequency": 5}
        workload["traffic"].update(n_objects=min(workload["traffic"]["n_objects"], 6),
                                   prefix_frames=8)
        workload["reference"]["max_iterations"] = 40
        seconds = 6
    return dict(bench=BENCH, workload=workload, config=config), seconds


def run_cell(cell, seed=3, prefix_frames=None):
    files, seconds = small_files(cell)
    if prefix_frames is not None:
        files["workload"]["traffic"]["prefix_frames"] = prefix_frames
    out = io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", "0"], device="cpu", stdout=out, files=files)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _unchanged(solve):
    def broken(*args, **kwargs):
        out = solve(*args, **kwargs)
        return (args[0],) + tuple(out[1:])
    return broken


def _half_batch(solve):
    def broken(*args, **kwargs):
        weights = args[5]
        w = weights.reproj.clone()
        live = torch.nonzero(w > 0)[:, 0]
        w[live[len(live) // 2:]] = 0
        return solve(*args[:5], weights._replace(reproj=w), *args[6:], **kwargs)
    return broken


def _altered(solve):
    def broken(*args, **kwargs):
        out = solve(*args, **kwargs)
        state = out[0]
        poses = state.poses.clone()
        poses[1:, 0] += 0.05
        return (state._replace(poses=poses),) + tuple(out[1:])
    return broken


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}
CELLS = ["gba.band_1024", "gba.loop_768", "objects.dense_chairs"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run_cell(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    from obvi_slam_tpu_torch import runner
    from obvi_slam_tpu_torch.solver import lm_fused

    broken = FAULTS[fault]
    # The window's two-phase solve on either path: the card's fused solve
    # (the gba driver's call, the runner's on CUDA) and the host loop (the
    # runner's on the CPU).
    monkeypatch.setattr(lm_fused, "solve_two_phase_fused",
                        broken(lm_fused.solve_two_phase_fused))
    monkeypatch.setattr(runner, "solve_two_phase_fused", broken(runner.solve_two_phase_fused))
    monkeypatch.setattr(runner, "solve_two_phase", broken(runner.solve_two_phase))
    result = run_cell(cell)
    assert not result["correct"], result["checks"]
    caught = [k for k, c in result["checks"].items()
              if k.startswith("suboptimality") and c["value"] > c["limit"]]
    assert caught, result["checks"]


def test_mini_ba_left_unchanged_is_not_correct(monkeypatch):
    """The frontend's pending-object mini-BAs return their state unchanged:
    ``suboptimality.mini_ba`` reads 1, over its limit. The small session's
    chairs are all in view from frame 0 and leave the mini-BAs after frame
    4, so its window starts at frame 2."""
    from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf

    for name in ("solve_fused", "solve"):
        monkeypatch.setattr(bbf, name, _unchanged(getattr(bbf, name)))
    result = run_cell("objects.dense_chairs", prefix_frames=2)
    check = result["checks"]["suboptimality.mini_ba"]
    assert check["value"] > check["limit"], result["checks"]
