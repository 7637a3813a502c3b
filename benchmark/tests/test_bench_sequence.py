"""The ``objects.ltm_revisit`` cell on the CPU at a small size, the harness's
look for a chip skipped: its two sessions drawn alike for one seed, a sound
run (set-up, the window to the session's end and the map's extraction, the
check) correct and traced with its per-layer readings, and a run whose map
carries an altered covariance not correct."""

import io
import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import two_sessions

CELL = "objects.ltm_revisit"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
SMALL = dict(n_frames=[20, 14], n_features=[200, 120])


def small_files():
    """The cell at a size the CPU runs in about a minute. Its limits are the
    cell's but for the first steps' norms (held at 1, as
    ``test_bench_faults.small_files`` holds them)."""
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{CELL}.json")
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{workload['config']}.json")
    workload["limits"]["first_step_norm.window_ba"] = 1.0
    config.update(SMALL)
    config["port_config"]["sliding_window_params"] = {"local_ba_window_size": 6,
                                                      "global_ba_frequency": 5}
    workload["traffic"].update(n_objects=6, prefix_frames=8)
    workload["reference"]["max_iterations"] = 40
    return dict(bench=BENCH, workload=workload, config=config)


def run_cell(seed=3, trace=0):
    out = io.StringIO()
    rc = harness.run(["--workload", CELL, "--seed", str(seed), "--seconds", "6",
                      "--trace", str(trace)], device="cpu", stdout=out, files=small_files())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_one_seed_draws_the_same_two_sessions():
    config = harness.load_json(harness.BENCH_DIR / "configs" / "obvi_ltm_sequence_base7a.json")
    kw = dict(SMALL, baseline=config["baseline"], odom_noise=config["odom_noise"])
    first, again, other = (two_sessions.two_sessions(seed, 6, **kw)
                           for seed in (2_147_500_123, 2_147_500_123, 2_147_500_124))
    for a, b, c in zip(first, again, other):
        for name in ("init_poses", "obs_px", "det_px", "feat_init"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert not np.array_equal(a.obs_px, c.obs_px)
    s1, s2 = first
    np.testing.assert_array_equal(s1.gt_objects, s2.gt_objects)
    np.testing.assert_array_equal(s1.gt_poses[:len(s2.gt_poses)], s2.gt_poses)
    assert not np.array_equal(s1.init_poses[:len(s2.init_poses)], s2.init_poses)
    for s in first:
        chairs = two_sessions.detection_objects(s)
        assert len(chairs) and chairs.min() >= 0


def test_sound_run_is_correct():
    result = run_cell()
    assert result["correct"], result["checks"]
    assert result["attempted"] == 14 - 8 and result["failed"] == 0
    assert {"covariance_error", "rank_repair_uncovered", "ltm_fallbacks",
            "ltm_missed_share", "table_mismatches"} <= set(result["checks"])
    assert "suboptimality.pgo" not in result["checks"]
    assert {"frames_per_s", "frame_ms_p90", "setup_s"} == set(result["metrics"])


def test_traced_run_reports_the_extractions_readings():
    result = run_cell(seed=5, trace=1)
    for name in ("ltm_covariance_ms.sequence", "ltm_rank_check_ms.sequence",
                 "ltm_far_features_ms.sequence"):
        assert result["metrics"][name]["value"] > 0, name
    # No device here: the range holds no device operation.
    assert result["metrics"]["ltm_covariance_device_ms.sequence"]["value"] == 0


def test_an_altered_covariance_is_not_correct(monkeypatch):
    """The map's covariances altered where they are produced (one entry of
    each block moved by 1e-6 of the block's largest)."""
    from obvi_slam_tpu_torch import ltm

    clamp = ltm._ensure_psd_covs

    def altered(covs, *args):
        out = clamp(covs, *args).copy()
        out[:, 2, 3] += 1e-6 * np.abs(out).max(axis=(1, 2))
        return out

    monkeypatch.setattr(ltm, "_ensure_psd_covs", altered)
    result = run_cell()
    check = result["checks"]["covariance_error"]
    assert not result["correct"] and check["value"] > check["limit"], result["checks"]


def test_control_fails_the_limits_it_sets():
    """``control_ltm.py`` at the CPU size: the program's own readings pass,
    the float32 covariances fail ``covariance_error``, and with the repair's
    priors taken out the reference's null directions go uncovered."""
    from benchmark import control_ltm

    files = small_files()
    limits = files["workload"]["limits"]
    program, control = control_ltm.readings(CELL, 3, device="cpu", files=files)
    assert program["covariance_error"] <= limits["covariance_error"]
    assert program["rank_repair_uncovered"] <= limits["rank_repair_uncovered"]
    assert control["covariance_error"] > limits["covariance_error"]
    for name in ("all", "one_object"):
        assert control[f"rank_repair_uncovered.{name}"] > limits["rank_repair_uncovered"]


def test_device_time_inside_a_range():
    """``_range_device_ms`` sums the union of the device operations' time
    inside each host range of the name (profiler microseconds to ms)."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from benchmark.drivers import sequence

    def event(name, kind, start, end):
        return NS(name=name, device_type=kind, time_range=NS(start=start, end=end),
                  is_user_annotation=False)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [event("obvi/ltm_covariance", cpu, 100, 200), event("k1", cuda, 90, 110),
              event("k2", cuda, 120, 150), event("k3", cuda, 140, 160),
              event("k4", cuda, 210, 230), event("obvi/ltm_covariance", cpu, 300, 310),
              event("k5", cuda, 301, 305), event("obvi/ltm_psd", cpu, 400, 410)]
    tracer = NS(_done=(NS(events=lambda: events), 1.0))
    out = sequence._range_device_ms(tracer, ("ltm_covariance", "ltm_psd", "ltm_seed"))
    assert out == {"ltm_covariance": pytest.approx((10 + 40 + 4) * 1e-3), "ltm_psd": 0.0}
    assert sequence._range_device_ms(NS(_done=None), ("ltm_covariance",)) == {}
