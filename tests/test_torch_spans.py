"""The port's spans (``timing.timer``) on small CPU sessions: they nest and
carry the frame id; under torch.profiler every span is a range
``obvi/<name>`` with its frame id in the CLI's ``--profile_trace_dir``
trace, on the clock of the profiler's own events; with no profiler
recording no range is opened; a frame's top-level stages are disjoint and
lie inside it; ``lm_fused.graph_stats["lm_iterations"]`` counts the fused
solves' iterations; and the benchmark's readers of the new spans and
counter."""

import json

import pytest
import torch

import obvi_slam_tpu_torch as ot
from benchmark import harness
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch import runner as prunner
from obvi_slam_tpu_torch import timing
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli
from obvi_slam_tpu_torch.solver import lm_fused
from obvi_slam_tpu_torch.synthetic import export_session_files
from torch_object_helpers import pgo_object_config

torch.set_num_threads(1)

# The spans of a CPU object session with PGO (the fused graph's entry and
# captures run on the card only).
CPU_SPANS = {"frame_pose_add", "visual_frontend_add_obs", "bb_frontend_hook",
             "window_ba_write_back", "problem_build_assemble", "problem_build_plan",
             "problem_build_upload", "mini_ba_build", "mini_ba_solve", timing.HOST_WAIT}
# A frame's disjoint top-level stages.
STAGES = ("frame_pose_add", "visual_frontend_add_obs", "bb_frontend_hook",
          "obj_only_pgo_full_process", "local_bundle_adjustment", "global_bundle_adjustment")
# Frame 0's data is added outside any frame.
ADDER = {"frame_data_adder", "offline_runner_online_portion"}
PARENTS = {
    "frame_pose_add": ADDER,
    "visual_frontend_add_obs": ADDER,
    "bb_frontend_hook": ADDER,
    "window_ba_write_back": {"local_bundle_adjustment", "global_bundle_adjustment"},
    "mini_ba_build": {"refine_initial_estimate_for_pending_objects"},
    "mini_ba_solve": {"refine_initial_estimate_for_pending_objects"},
}


def _innermost(intervals):
    """For each (start, end, ...) interval, in the input order, the index
    of the innermost other interval that encloses it, or None."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    out, stack = [None] * len(intervals), []
    for i in order:
        start, end = intervals[i][:2]
        while stack and not (intervals[stack[-1]][0] <= start and end <= intervals[stack[-1]][1]):
            stack.pop()
        out[i] = stack[-1] if stack else None
        stack.append(i)
    return out


def _config(iterations):
    """The object test config with PGO (torch_object_helpers), a 2-frame
    window, PGO on frames 1 and 4 and the last, every solve capped at
    ``iterations`` LM iterations."""
    c = pgo_object_config(pcfg)
    c.sliding_window_params.local_ba_window_size = 2
    c.sliding_window_params.global_ba_frequency = 4
    for p in (c.local_ba_iteration_params, c.global_ba_iteration_params,
              c.final_ba_iteration_params):
        p.phase_one_opt_params.max_num_iterations = iterations
        p.phase_two_opt_params.max_num_iterations = iterations
    pgo = c.pgo_solver_params
    for p in (c.feature_based_bb_association_params.pending_obj_estimator_params.solver_params,
              pgo.pre_pgo_tracking_solver_params, pgo.pgo_optimization_solver_params,
              pgo.final_pgo_optimization_solver_params, pgo.post_pgo_vf_adjustment_solver_params,
              pgo.final_post_pgo_vf_adjustment_solver_params):
        p.max_num_iterations = iterations
    return c


def _run_cli(root, n_frames, iterations, *extra):
    """The main CLI at f64 on the CPU, every solve fused, on an object
    session of ``n_frames``, every span kept; (exit code, spans, timing
    report)."""
    data, gt, _ = ot.synthetic_object_session(n_frames=n_frames)
    export_session_files(data, gt, root)
    pcfg.write_config(_config(iterations), str(root / "config.json"))
    reg = timing.TimerRegistry.instance()
    reg.record_spans()
    try:
        rc = main_cli.main([
            "--params_config_file", str(root / "config.json"),
            "--intrinsics_file", str(root / "intrinsics.csv"),
            "--extrinsics_file", str(root / "extrinsics.csv"),
            "--poses_by_node_id_file", str(root / "poses.csv"),
            "--bounding_boxes_by_node_id_file", str(root / "bounding_boxes.csv"),
            "--low_level_feats_dir", str(root / "orb_out"),
            "--device", "cpu", "--f64", "--fused_solver", "on",
            "--timing_report_file", str(root / "timing.json"), *extra,
        ])
        spans = reg.spans
    finally:
        reg.record_spans(False)
    with open(root / "timing.json") as f:
        return rc, spans, json.load(f)


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range was opened with no profiler recording")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A 6-frame session at 2 LM iterations a solve with no profiler, a
    profiler range refused, and the fused solves' summaries."""
    summaries = []

    def spy(fn, n_summaries):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            summaries.extend(out[1:1 + n_summaries])
            return out
        return call

    before = lm_fused.graph_stats["lm_iterations"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(timing, "_RecordFunctionFast", _refuse)
        mp.setattr(prunner, "solve_fused", spy(prunner.solve_fused, 1))
        mp.setattr(prunner, "solve_two_phase_fused", spy(prunner.solve_two_phase_fused, 2))
        profiling = timing._profiler_enabled()
        rc, spans, report = _run_cli(tmp_path_factory.mktemp("session"), 6, 2)
    return dict(rc=rc, spans=spans, report=report, summaries=summaries, profiling=profiling,
                lm_iterations=lm_fused.graph_stats["lm_iterations"] - before)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A 5-frame session under ``--profile_trace_dir`` (no LM iteration, so
    that the trace stays small) and its Chrome trace's complete events."""
    root = tmp_path_factory.mktemp("traced")
    rc, spans, report = _run_cli(root, 5, 0, "--profile_trace_dir", str(root / "trace"))
    with open(root / "trace" / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return dict(rc=rc, spans=spans, report=report, events=events)


def test_session_reports_every_span(session):
    assert session["rc"] == 0
    report = session["report"]
    assert CPU_SPANS <= set(report)
    assert all(report[name]["invocations"] > 0 for name in CPU_SPANS)
    assert {s.name for s in session["spans"]} == set(report)


def test_no_profiler_range_without_a_profiler(session):
    """The session ran with both kinds of profiler range refused."""
    assert session["rc"] == 0 and not session["profiling"]
    assert timing.TimerRegistry.instance().open_spans == []


def test_spans_nest_and_carry_the_frame_id(session):
    spans = session["spans"]
    enclosing = _innermost([(s.start_s, s.end_s) for s in spans])
    for s, k in zip(spans, enclosing):
        assert s.parent == (None if k is None else spans[k].name), s
        if s.name in PARENTS:
            assert s.parent in PARENTS[s.name], s
        if s.name.startswith("problem_build_"):
            assert (s.parent.endswith("build_opt") or s.parent.startswith("obj_only_pgo_")
                    or (s.name, s.parent) == ("problem_build_upload", "mini_ba_build")), s
    frames = [s for s in spans if s.name == "optimization_iteration"]
    assert [s.frame for s in frames] == [1, 2, 3, 4, 5]
    names = set()
    for frame in frames:
        inside = [s for s in spans if frame.start_s <= s.start_s and s.end_s <= frame.end_s]
        assert all(s.frame == frame.frame for s in inside)
        names |= {s.name for s in inside}
    assert CPU_SPANS <= names


def test_stages_are_disjoint_and_inside_the_frame(session):
    spans = session["spans"]
    for frame in (s for s in spans if s.name == "optimization_iteration"):
        # The frame's stages; the last frame's id also marks the final
        # optimization, after the frames.
        stages = sorted((s for s in spans if s.name in STAGES and s.frame == frame.frame
                         and s.parent in ("frame_data_adder", "optimization_iteration")),
                        key=lambda s: s.start_s)
        assert {s.name for s in stages} >= {"frame_pose_add", "visual_frontend_add_obs",
                                            "bb_frontend_hook"}
        for s in stages:
            assert frame.start_s <= s.start_s and s.end_s <= frame.end_s
        for a, b in zip(stages, stages[1:]):
            assert a.end_s <= b.start_s, (a, b)


def test_lm_iterations_count_the_fused_summaries(session):
    assert session["summaries"]
    n = sum(s.num_iterations for s in session["summaries"])
    assert n > 0 and session["lm_iterations"] == n


def test_trace_holds_every_span_with_its_frame_and_duration(traced):
    assert traced["rc"] == 0
    prefix = timing.PROFILER_PREFIX
    ranges = [e for e in traced["events"] if e["name"].startswith(prefix)]
    spans = traced["spans"]
    assert len(ranges) == len(spans)
    assert CPU_SPANS <= {e["name"][len(prefix):] for e in ranges}
    by_name = {}
    for e in sorted(ranges, key=lambda e: e["ts"]):
        by_name.setdefault(e["name"][len(prefix):], []).append(e)
    pairs = []  # (span, its range), in the order of each name's starts
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_s)
        assert len(by_name[name]) == len(mine), name
        pairs += zip(mine, by_name[name])
    for s, e in pairs:
        assert e["args"].get("frame") == s.frame, (e, s)
        dur_us = (s.end_s - s.start_s) * 1e6
        assert abs(e["dur"] - dur_us) <= max(0.05 * dur_us, 50.0), (e, s)
    # The ranges nest as the spans do, on the clock of the profiler's own
    # operator events.
    enclosing = _innermost([(e["ts"], e["ts"] + e["dur"]) for _, e in pairs])
    for (s, e), k in zip(pairs, enclosing):
        assert (None if k is None else pairs[k][1]["name"]) == (
            None if s.parent is None else prefix + s.parent), (e, s)
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in traced["events"]
           if e["name"].startswith("aten::")]
    for e in (e for e in ranges if e["name"] == prefix + "mini_ba_solve"):
        assert any(e["ts"] <= a and b <= e["ts"] + e["dur"] for a, b in ops), e


# ---- the benchmark's readers of the spans and the counter -------------------

TIMERS = {"optimization_iteration": 2.0, "frame_data_adder": 0.9, "frame_pose_add": 0.05,
          "visual_frontend_add_obs": 0.3, "bb_frontend_hook": 0.5,
          "obj_only_pgo_full_process": 0.4, "local_bundle_adjustment": 0.7,
          "problem_build_upload": 0.02, timing.HOST_WAIT: 0.25}
READERS = {
    "visual_frontend_ms_per_frame.session": 0.3 * 1e3 / 4,
    "build_upload_ms_per_frame.session": 0.02 * 1e3 / 4,
    "device_wait_ms_per_frame.session": 0.25 * 1e3 / 4,
    "lm_iterations_per_frame.session": 90 / 4,
    "frame_other_ms_per_frame.session": (2.0 - 0.05 - 0.3 - 0.5 - 0.4 - 0.7) * 1e3 / 4,
}


def _reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"metric_{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_hand_made_record(name):
    record = dict(frames=4, timers=TIMERS, graph_stats=dict(captures=0, lm_iterations=90))
    assert _reader(name).read(record) == pytest.approx(READERS[name], rel=1e-12)
    # A program without the spans and the counter (the parent's timers).
    older = dict(frames=4, timers={k: v for k, v in TIMERS.items() if k in (
        "optimization_iteration", "frame_data_adder", "obj_only_pgo_full_process",
        "local_bundle_adjustment")}, graph_stats=dict(captures=0))
    assert _reader(name).read(older) is None
    assert _reader(name).read({"frames": 0, "trace": None}) is None
