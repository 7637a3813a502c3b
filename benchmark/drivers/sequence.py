"""Driver of the ``ltm`` cells: the second session of a multi-session
deployment, seeded from the first session's long-term object map (LTM), up
to the session's end and the extraction of the next map.

Set-up draws two sessions of one world from the seed
(``traffic/two_sessions.py``) and writes each in ObVi-SLAM's input file
formats into a directory under ``TMPDIR``.

Session 1's map is made by the program's own path from session 1's whole
pose graph, not frame by frame: the session is read through the entry
point (``build_session``), every frame's pose and odometry factor is added
as the runner adds it, every feature track with its initial position and
every observation, and each chair with the single-view estimate of its
detections (their median) and all its detections, associated by ground
truth. A two-phase visual BA over the whole pose graph stands in for the
session's window BAs, the final iteration then runs as configured (base7a:
PGO), and ``extract_long_term_object_map`` makes the map, as
``cli/run_opt_from_pg_state.py`` and ``cli/ltm_extraction_only.py`` do. The
map goes through its JSON file.

Session 2 is built through ``build_session`` with
``--long_term_map_input`` (every LTM object pre-inserted with its prior)
and ``--long_term_map_output``, its pools presized from the raw data and
the map's objects, and its prefix frames run as the session driver runs
them. The window runs the frames after the prefix, each timed by the host
clock, then the last frame: its iteration, the session's end
(``runner.run_offline_portion``: the final refinement and the merge loop)
and ``write_outputs``, which extracts the new map in float64. The window
always runs to that end; ``--seconds`` does not cut it. The traced window
holds the last ``trace_frames`` frames.

The check takes the session driver's sample of window BAs, PGO-family
solves and mini-BAs and its checks, and adds the extraction's:
``table_mismatches`` also counts the extraction problem's rows and every
sampled problem's LTM rows that differ from the raw files or the loaded
map; ``covariance_error`` is the largest relative Frobenius error of the
new map's covariances against the plain float64 reference
(``reference/covariance.py``) on the extraction problem as the program
built it; ``rank_repair_uncovered`` is the largest share of a null
direction of that problem without the repair's priors that lies outside
the parameters the priors hold (1: a null direction left unrepaired);
``ltm_fallbacks`` counts extractions
that fell back to the old map; ``ltm_missed_share`` is the share of the
chairs in view in session 2 whose detections its map does not hold under
their LTM id.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import session as session_driver
from benchmark.reference import build, covariance
from benchmark.traffic import files, two_sessions

TRAFFIC_KEYS = ("n_frames", "n_features", "baseline", "odom_noise")


def _argv(work: Path, device: str, *extra):
    return ["--params_config_file", str(work.parent / "config.json"),
            "--intrinsics_file", str(work / "intrinsics.csv"),
            "--extrinsics_file", str(work / "extrinsics.csv"),
            "--poses_by_node_id_file", str(work / "poses.csv"),
            "--bounding_boxes_by_node_id_file", str(work / "bounding_boxes.csv"),
            "--low_level_feats_dir", str(work / "orb_out"), "--device", device, *extra]


def _corner_index(raw, det_obj):
    """{(frame, camera, corners as read back): chair} of a session's
    detections (the files hold each number as Python writes it, so the read
    corners equal the raw ones bit for bit)."""
    return {(f, c, tuple(p)): o for f, c, p, o in zip(raw.det_frame.tolist(),
                                                     raw.det_cam.tolist(),
                                                     raw.det_px.tolist(), det_obj.tolist())}


def _session_one_map(work: Path, raw, device: str):
    """Session 1's LTM (see the module docstring) and {chair: object id}."""
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main
    from obvi_slam_tpu_torch.frontend.bounding_box_frontend import (
        bb_covariance, single_view_ellipsoid_estimate)
    from obvi_slam_tpu_torch.ltm import extract_long_term_object_map

    session = cli_main.build_session(cli_main.parse_args(_argv(work, device)))
    runner, data, pg, config = session.runner, session.data, session.pg, session.config
    max_frame = data.max_frame_id()
    for frame in range(max_frame + 1):
        runner._add_frame_pose(data, pg, frame)
    std = config.visual_feature_params.reprojection_error_std_dev
    for feat, track in data.feature_tracks.items():
        pg.add_feature(feat, data.feature_init_positions[feat])
        for frame, by_cam in track.items():
            for cam, pixel in by_cam.items():
                pg.add_visual_factor(frame, cam, feat, pixel, std)
    chair_of = _corner_index(raw, two_sessions.detection_objects(raw))
    boxes = {}
    for frame, by_cam in sorted(data.bounding_boxes.items()):
        for cam, bbs in sorted(by_cam.items()):
            for bb in bbs:
                chair = chair_of[(frame, cam, tuple(bb.corners.tolist()))]
                boxes.setdefault(chair, []).append((frame, cam, bb))
    cov_params = config.bounding_box_covariance_generator_params
    img_hw = session.bb_frontend.img_hw
    ids = {}
    for chair, seen in sorted(boxes.items()):
        estimates = [single_view_ellipsoid_estimate(pg, f, c, bb.semantic_class, bb.corners)
                     for f, c, bb in seen]
        estimate = np.median(np.stack([e for e in estimates if e is not None]), 0)
        obj = ids[chair] = pg.add_new_ellipsoid(estimate, seen[0][2].semantic_class)
        for f, c, bb in seen:
            pg.add_object_observation(obj, f, c, bb.corners,
                                      bb_covariance(bb, c, cov_params, img_hw))
    # Frame by frame, the session's window BAs keep its trajectory to its
    # features; one visual BA over the whole pose graph (the final BA's
    # parameters) stands in for them, then the final iteration runs as
    # configured (base7a: PGO only, which keeps the trajectory's shape).
    en = config.optimization_factors_enabled_params
    final_pgo = en.use_pose_graph_on_final_global_ba
    en.use_pose_graph_on_final_global_ba = False
    try:
        ok = runner.run_optimization_iteration(data, pg, 0, max_frame, max_frame, attempt_num=1)
    finally:
        en.use_pose_graph_on_final_global_ba = final_pgo
    if not (ok and runner.run_optimization_iteration(data, pg, 0, max_frame, max_frame,
                                                     attempt_num=1)):
        raise RuntimeError("session 1's final global BA failed")
    ltm = extract_long_term_object_map(pg, config, session.bb_frontend.get_front_end_obj_map_data(),
                                       device=device)
    if ltm is None:
        raise RuntimeError("session 1's LTM extraction failed")
    return ltm, ids


def _stats(ctx):
    """(the LTM counters, the fused solves' graph counters)."""
    from obvi_slam_tpu_torch.ltm import ltm_stats
    from obvi_slam_tpu_torch.solver import lm_fused

    ltm = {f"ltm.{k}": v for k, v in ltm_stats.items()}
    ltm["ltm_merges"] = ctx["session"].bb_frontend.ltm_merges
    return ltm, {k: v for k, v in lm_fused.graph_stats.items() if isinstance(v, (int, float))}


def _capture_extraction(ctx):
    """Keeps the extraction problem and the arguments of each marginal-
    covariance call of the program's LTM module from now on."""
    from obvi_slam_tpu_torch import ltm as ltm_mod

    seen = ctx["extraction"] = {"calls": []}
    build_problem, covs = ltm_mod.build_problem, ltm_mod.compute_marginal_covariances

    def keep_problem(*args, **kwargs):
        seen["problem"] = build_problem(*args, **kwargs)
        return seen["problem"]

    def keep_call(*args, **kwargs):
        seen["calls"].append((args, kwargs))
        return covs(*args, **kwargs)

    ltm_mod.build_problem, ltm_mod.compute_marginal_covariances = keep_problem, keep_call
    ctx["restore"] += [(ltm_mod, "build_problem", build_problem),
                       (ltm_mod, "compute_marginal_covariances", covs)]


def setup(workload, config, seed, device):
    # The counters this cell reads; a program without them fails here.
    from obvi_slam_tpu_torch.ltm import ltm_stats  # noqa: F401
    from obvi_slam_tpu_torch import config as cfg
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main
    from obvi_slam_tpu_torch.solver import lm_fused

    traffic = workload["traffic"]
    raws = two_sessions.two_sessions(seed, traffic["n_objects"],
                                     **{k: config[k] for k in TRAFFIC_KEYS})
    root = Path(tempfile.mkdtemp(prefix="obvi_bench_sequence_"))
    cfg.write_config(session_driver._port_config(config), str(root / "config.json"))
    works = [files.write_session(raw, root / f"session_{i + 1}") for i, raw in enumerate(raws)]
    ltm, ltm_ids = _session_one_map(works[0], raws[0], device)
    ltm.save(str(root / "ltm_1.json"))
    lm_fused.clear_graphs()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    argv = _argv(works[1], device, "--long_term_map_input", str(root / "ltm_1.json"),
                 "--long_term_map_output", str(root / "ltm_2.json"),
                 "--logs_directory", str(root / "logs"))
    session = cli_main.build_session(cli_main.parse_args(argv))
    sampler = session_driver.Sampler(seed, workload["sample_per_kind"])
    restore = session_driver._instrument(session, sampler)
    runner, data = session.runner, session.data
    max_frame = data.max_frame_id()
    runner.visual_frontend = session.visual_frontend
    runner.presize_session_caps(data, max_frame, n_ltm=len(session.pg.ltm_object_ids))
    runner.add_frame_data(data, session.pg, 0, 0)
    ctx = dict(session=session, raw=raws[1], sampler=sampler, workload=workload, config=config,
               device=device, max_frame=max_frame, next_frame=1, restore=restore, root=root,
               ltm_ids=ltm_ids,
               ltm_in={o: (np.asarray(e), np.asarray(session.prev_ltm.covariances[o]))
                       for o, (_, e) in session.prev_ltm.ellipsoids.items()})
    for _ in range(1, traffic["prefix_frames"]):
        if not session_driver._frame(ctx):
            raise RuntimeError(f"frame {ctx['next_frame'] - 1} of the prefix failed")
    _capture_extraction(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    return ctx


def _last_frame(ctx) -> bool:
    """The last frame's iteration, the session's end and its outputs."""
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main

    session = ctx["session"]
    runner, data, pg = session.runner, session.data, session.pg
    ok = session_driver._frame(ctx)
    ok = ok and runner.run_offline_portion(data, pg, ctx["max_frame"])
    ctx["ltm_out"] = cli_main.write_outputs(session)
    return ok and ctx["ltm_out"] is not None


def _range_device_ms(tracer, names):
    """Device ms of the operations inside each of the program's profiler
    ranges ``obvi/<name>`` of the traced window; empty where the window was
    not traced or the program has no such range."""
    done = getattr(tracer, "_done", None)
    if not done:
        return {}
    from torch.autograd import DeviceType

    events = done[0].events()
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    out = {}
    for name in names:
        ranges = [(e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CPU and e.name == "obvi/" + name]
        if not ranges:
            continue
        inside = [(max(s, lo), min(t, hi)) for lo, hi in ranges for s, t in device
                  if s < hi and t > lo]
        out[name] = sum(t - s for s, t in harness._union(inside)) * 1e-3
    return out


def measure(ctx, seconds, tracer):
    sampler = ctx["sampler"]
    cuda = ctx["device"] == "cuda"
    trace_from = ctx["max_frame"] - ctx["workload"]["trace_frames"] + 1 if tracer.enabled else None
    timers0, (stats0, graphs0) = session_driver._timers(), _stats(ctx)
    frame_s, failed = [], 0
    first = ctx["next_frame"]
    sampler.active = True
    t0 = time.perf_counter()
    while ctx["next_frame"] <= ctx["max_frame"]:
        if ctx["next_frame"] == trace_from:
            tracer.start()
        t_frame = time.perf_counter()
        with harness.span("frame"):
            last = ctx["next_frame"] == ctx["max_frame"]
            ok = _last_frame(ctx) if last else session_driver._frame(ctx)
        if cuda:
            torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_frame)
        sampler.commit()
        failed += int(not ok)
    sampler.active = False
    if tracer.active:
        tracer.stop()
    window = time.perf_counter() - t0
    if window > seconds:
        print(f"the window ran {window:.4f} s, past --seconds {seconds}: it always runs "
              "to the session's end", file=sys.stderr)
    timers = {k: v - timers0.get(k, 0.0) for k, v in session_driver._timers().items()}
    stats, graphs = _stats(ctx)
    stats = {k: v - stats0.get(k, 0) for k, v in stats.items()}
    graphs = {k: v - graphs0.get(k, 0) for k, v in graphs.items()}
    end = {k: v for k, v in timers.items() if k.startswith(("ltm_", "offline_runner_o", "post_"))}
    print(f"window: frames {first}-{ctx['max_frame']}, {len(frame_s)} frames in {window:.4f} s; "
          f"last frame {frame_s[-1]:.4f} s; the session's end {end}; counters {stats}; "
          f"graphs {graphs}; "
          f"frame ms {[round(t * 1e3, 1) for t in frame_s]}", file=sys.stderr)
    return harness.Measured(
        e2e={"frames_per_s": len(frame_s) / window,
             "frame_ms_p90": float(np.percentile(np.array(frame_s) * 1e3, 90))},
        attempted=len(frame_s), failed=failed,
        record=dict(frames=len(frame_s), timers=timers, graph_stats=graphs, counters=stats,
                    ltm_device_ms=_range_device_ms(tracer, ("ltm_covariance",))),
    )


def _missed_share(ctx, pg):
    """(share of the chairs in view in session 2 whose detections its map
    does not hold under their LTM id, chairs in view, {missed chair: (first
    and last frame it was detected in, frames, the objects that hold its
    detections, -1 for none)})."""
    raw = ctx["raw"]
    det_obj = two_sessions.detection_objects(raw)
    frames = {}
    for f, o in zip(raw.det_frame.tolist(), det_obj.tolist()):
        frames.setdefault(o, set()).add(f)
    need = ctx["session"].config.feature_based_bb_association_params.min_observations
    in_view = sorted(o for o, fr in frames.items() if o >= 0 and len(fr) >= need)
    chair_of = _corner_index(raw, det_obj)
    holders = {}
    for obj, fids in pg.obj_obs_by_object.items():
        for fid in fids:
            obs = pg.object_observations[fid]
            chair = chair_of.get((obs.frame_id, obs.camera_id, tuple(obs.corners.tolist())))
            holders.setdefault(chair, set()).add(obj)
    missed = {}
    for chair in in_view:
        held = holders.get(chair, set())
        if ctx["ltm_ids"].get(chair) not in held:
            fr = sorted(frames[chair])
            missed[chair] = (fr[0], fr[-1], len(fr), sorted(held) or [-1])
    return (len(missed) / len(in_view) if in_view else 0.0), len(in_view), missed


def release(ctx):
    """The extraction problem, the new map's covariances and the
    association's ground truth go to the host; then the session driver's
    release."""
    session = ctx["session"]
    ctx["obj_rows"] = [None if kind == "mini_ba" else r["problem"].obj_rows
                       for kind, r in ctx["sampler"].sample()]
    ext = ctx.pop("extraction")
    args, kwargs = ext["calls"][-1]
    state, cams, tables, plan, free, weights = args[:6]
    huber = args[6] if len(args) > 6 else kwargs["huber"]
    problem = ext["problem"]
    ltm_out = ctx.pop("ltm_out")
    obj_rows = np.asarray(problem.obj_rows)
    ctx["extraction"] = dict(
        arrays=session_driver._plain_arrays(state, cams, tables, free, weights),
        huber=session_driver._huber(huber), pose_rows=problem.pose_rows,
        point_rows=problem.point_rows, obj_rows=obj_rows,
        program=np.stack([np.full((7, 7), np.nan) if ltm_out is None
                          else ltm_out.covariances.get(int(o), np.full((7, 7), np.nan))
                          for o in obj_rows]))
    ctx["missed"] = _missed_share(ctx, session.pg)
    session_driver.release(ctx)
    shutil.rmtree(ctx.pop("root"), ignore_errors=True)


def _check_ltm_rows(a, obj_rows, ltm_in):
    """(LTM prior rows that differ from the loaded map, rows checked): each
    live row's mean is its object's ellipsoid and its whitening the
    principal inverse square root of its covariance (to 1e-5 of its norm: a
    float32 table's rounding; the covariance's spread of eigenvalues, 1e12
    where a direction was repaired, rules out comparing informations)."""
    live = np.nonzero(a["ltm_mask"])[0]
    bad = 0
    for i in live.tolist():
        want = ltm_in.get(int(obj_rows[a["ltm_obj"][i]]))
        if want is None:
            bad += 1
            continue
        mean, cov = want
        w, v = np.linalg.eigh(cov)
        sqrt_inf = (v / np.sqrt(w)) @ v.T
        err = np.linalg.norm(a["ltm_sqrt_inf"][i] - sqrt_inf)
        bad += int(not (np.allclose(a["ltm_mean"][i], mean, rtol=1e-6, atol=1e-6)
                        and err <= 1e-5 * np.linalg.norm(sqrt_inf)))
    return bad, len(live)


def check(ctx, measured):
    checks = session_driver.check(ctx, measured)
    t0 = time.perf_counter()
    index = session_driver.RawIndex(ctx["raw"])
    bad = 0
    for case, obj_rows in zip(ctx["cases"], ctx["obj_rows"]):
        if obj_rows is not None:
            bad += _check_ltm_rows(case["arrays"], obj_rows, ctx["ltm_in"])[0]
    ext = ctx["extraction"]
    a = ext["arrays"]
    ext_bad, checked = session_driver._check_tables(a, index, ext["pose_rows"],
                                                    ext["point_rows"])
    ltm_bad, ltm_checked = _check_ltm_rows(a, ext["obj_rows"], ctx["ltm_in"])
    bad += ext_bad + ltm_bad
    prob = build.plain_problem(a, ext["huber"], dtype=torch.float64, device=ctx["device"])
    ref = covariance.marginal_covariances(prob)
    uncovered, n_null, low, gap = covariance.repair_uncovered(prob)
    rows = prob.keep["objects"]
    readings = {
        "covariance_error": covariance.relative_error(ext["program"][rows], ref),
        "rank_repair_uncovered": uncovered,
        "ltm_fallbacks": float(measured.record["counters"]["ltm.fallbacks"]),
        "ltm_missed_share": ctx["missed"][0],
    }
    print(f"reference: extraction {len(rows)} objects, {ext_bad + ltm_bad} of "
          f"{checked + ltm_checked} table rows differ, {n_null} null directions (eigenvalues "
          f"over the largest: smallest {low!r}, smallest above the bar {gap!r}), "
          f"{ctx['missed'][1]} chairs in view, missed {ctx['missed'][2]}, "
          f"in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    out = [c for c in checks if c.name != "table_mismatches"]
    prior = {c.name: c.value for c in checks}.get("table_mismatches", 0.0)
    readings["table_mismatches"] = prior + float(bad)
    return out + harness.checks_of(readings, ctx["workload"]["limits"])
