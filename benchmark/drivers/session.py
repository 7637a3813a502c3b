"""Driver of the ``objects`` cells: an object-visual SLAM session at the
paper config, frame by frame, as a user runs it.

Set-up draws the session from the seed (``traffic/object_session.py``),
writes it in ObVi-SLAM's input file formats into a directory under
``TMPDIR``, writes the configuration, reads both through the program's
entry point (``build_session``, so host I/O is set-up) and runs the
cell's prefix frames: the caps presized from the raw data, as
``run_optimization`` does, the window filled and the first global BA done.
The window then runs the frames after the prefix with the runner's own
per-frame calls (data adding, then the frame's optimization), each frame
timed by the host clock, up to the end of the last whole frame.

The session runs with the optimization logger on (``--logs_directory``, as
ObVi-SLAM's evaluation runs it; nothing is written, the records stay in
memory), so every solve returns its iteration records. The check compares
a sample of the window's solves, drawn from the seed
(a reservoir per kind, and the last of each kind): window BAs
(``runner._solve_two_phase``), the runner's other solves (``runner.solve``:
in this config PGO, its tracking and its feature adjustment) and the frontend's pending-object mini-BAs. The
reference follows the program from its own state: it takes each sampled
solve's problem as the program built it (the window's factors are the
frontends' associations, the program's state), first checks every
observation row of it against the raw inputs (``table_mismatches``), then
solves it in float64 by itself and judges the program's answer by the share
of the decrease it misses (``suboptimality.<kind>``) and the program's first
LM step by how far its norm lies from the reference's first step from the
same state (``first_step_norm.<kind>``). A window BA's phase 1 stops by the
configuration's phase-one rule (base7a: at a relative decrease under 1e-3),
since its state picks phase 2's outliers; phase 2 and the other solves run
to the end of the reference's own descent.
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
from benchmark.reference import build, lm as ref_lm
from benchmark.traffic import files, object_session

SESSION_KEYS = ("n_frames", "n_features", "baseline", "odom_noise")
KINDS = ("window_ba", "pgo", "mini_ba")


def _set_fields(group, values, path):
    """Sets ``values`` on ``group`` field by field, nested groups likewise."""
    for name, v in values.items():
        if not hasattr(group, name):
            raise KeyError(f"{path}.{name} is no parameter of the program")
        if isinstance(v, dict):
            _set_fields(getattr(group, name), v, f"{path}.{name}")
        else:
            setattr(group, name, v)


def _port_config(config):
    """The program's FullOVSLAMConfig: its defaults, each parameter group of
    ``port_config`` set field by field, and the shape priors (mean, std)."""
    from obvi_slam_tpu_torch import config as cfg

    c = cfg.FullOVSLAMConfig()
    for key, value in config["port_config"].items():
        if key == "shape_dimension_priors":
            c.shape_dimension_priors = [
                cfg.ShapeDimensionPrior(p["class"], np.array(p["mean"]),
                                        np.diag(np.array(p["std"]) ** 2))
                for p in value
            ]
        elif isinstance(value, dict):
            _set_fields(getattr(c, key), value, key)
    return c


class Sampler:
    """Keeps a seeded reservoir of ``k`` solves of each kind, and the last
    one, among the solves of the frames handed to ``commit``."""

    def __init__(self, seed, k):
        self.rng = np.random.default_rng(seed)
        self.k = k
        self.pending = []
        self.seen = dict.fromkeys(KINDS, 0)
        self.kept = {kind: [] for kind in KINDS}
        self.last = dict.fromkeys(KINDS)
        self.active = False

    def add(self, kind, record):
        if self.active:
            self.pending.append((kind, record))

    def commit(self):
        for kind, record in self.pending:
            n = self.seen[kind]
            self.seen[kind] = n + 1
            self.last[kind] = record
            if n < self.k:
                self.kept[kind].append(record)
            else:
                j = int(self.rng.integers(0, n + 1))
                if j < self.k:
                    self.kept[kind][j] = record
        self.pending = []

    def drop(self):
        self.pending = []

    def sample(self):
        out = []
        for kind in KINDS:
            records = list(self.kept[kind])
            if self.last[kind] is not None and all(r is not self.last[kind] for r in records):
                records.append(self.last[kind])
            out += [(kind, r) for r in records]
        return out


def _clone_state(state):
    return type(state)(*(x.detach().clone() for x in state))


def _instrument(session, sampler):
    """Spans around the calls into the program's layers, and the sampler's
    view of every solve. Returns [(object, attribute, original)] of the
    module attributes it replaced, for ``release`` to restore."""
    from obvi_slam_tpu_torch import runner as runner_mod
    from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf

    runner = session.runner
    harness.wrap(session.visual_frontend, "add_visual_feature_observations", "visual_frontend")
    if session.hooks.bb_frontend is not None:
        harness.wrap(session.hooks, "bb_frontend", "bb_frontend")
    restore = [(runner_mod, name, harness.wrap(runner_mod, name, "pgo"))
               for name in ("run_tracking_solve", "run_pgo_plus_ellipsoids")]
    harness.wrap(runner, "_build_problem", "build_problem")

    def window_ba(args, kwargs, out):
        problem, iteration_params = args[0], args[1]
        sampler.add("window_ba", dict(problem=problem, params=iteration_params,
                                      x0=_clone_state(problem.state), out=out[0],
                                      first=harness.first_record(out[1])))

    def pgo_solve(args, kwargs, out):
        problem = args[0]
        weights = kwargs.get("weights", args[2] if len(args) > 2 else None)
        params = kwargs.get("params", args[1] if len(args) > 1 else None)
        sampler.add("pgo", dict(problem=problem, weights=weights or problem.weights,
                                params=params, x0=_clone_state(problem.state), out=out[0],
                                first=harness.first_record(out[1])))

    def mini_ba(args, kwargs, out):
        names = ("state", "cams", "tables", "plan", "free", "weights")
        given = dict(zip(names, args), **{k: v for k, v in kwargs.items() if k in names})
        sampler.add("mini_ba", dict(given, huber=kwargs.get("huber"),
                                    params=kwargs.get("params"),
                                    x0=_clone_state(given["state"]), out=out[0],
                                    first=harness.first_record(out[1])))

    harness.wrap(runner, "_solve_two_phase", "window_ba_solve", after=window_ba)
    harness.wrap(runner, "solve", "pgo_solve", after=pgo_solve)
    restore += [(bbf, name, harness.wrap(bbf, name, "mini_ba", after=mini_ba))
                for name in ("solve_fused", "solve")]
    return restore


def setup(workload, config, seed, device):
    from obvi_slam_tpu_torch import config as cfg
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main

    traffic = workload["traffic"]
    raw = object_session.synthetic_object_session(
        seed=seed, n_objects=traffic["n_objects"], **{k: config[k] for k in SESSION_KEYS})
    work = Path(tempfile.mkdtemp(prefix="obvi_bench_session_"))
    files.write_session(raw, work)
    cfg.write_config(_port_config(config), str(work / "config.json"))
    argv = ["--params_config_file", str(work / "config.json"),
            "--intrinsics_file", str(work / "intrinsics.csv"),
            "--extrinsics_file", str(work / "extrinsics.csv"),
            "--poses_by_node_id_file", str(work / "poses.csv"),
            "--bounding_boxes_by_node_id_file", str(work / "bounding_boxes.csv"),
            "--low_level_feats_dir", str(work / "orb_out"), "--device", device,
            "--logs_directory", str(work / "logs")]
    session = cli_main.build_session(cli_main.parse_args(argv))
    shutil.rmtree(work, ignore_errors=True)
    sampler = Sampler(seed, workload["sample_per_kind"])
    restore = _instrument(session, sampler)
    runner, data = session.runner, session.data
    max_frame = data.max_frame_id()
    runner.visual_frontend = session.visual_frontend
    runner.presize_session_caps(data, max_frame)
    runner.add_frame_data(data, session.pg, 0, 0)
    ctx = dict(session=session, raw=raw, sampler=sampler, workload=workload, config=config,
               device=device, max_frame=max_frame, next_frame=1, restore=restore)
    for _ in range(1, traffic["prefix_frames"]):
        if not _frame(ctx):
            raise RuntimeError(f"frame {ctx['next_frame'] - 1} of the prefix failed")
    if device == "cuda":
        torch.cuda.synchronize()
    return ctx


def _frame(ctx) -> bool:
    """The runner's per-frame calls of ``run_optimization`` for the next
    frame: data adding, then the frame's optimization."""
    from obvi_slam_tpu_torch.runner import provide_optimization_window
    from obvi_slam_tpu_torch.timing import timer

    session, frame = ctx["session"], ctx["next_frame"]
    runner, data, pg = session.runner, session.data, session.pg
    ctx["next_frame"] = frame + 1
    with timer("optimization_iteration"):
        start = provide_optimization_window(frame, ctx["max_frame"],
                                            runner.config.sliding_window_params)
        with timer("frame_data_adder"):
            runner.add_frame_data(data, pg, start, frame)
        return runner.run_optimization_iteration(data, pg, start, frame, ctx["max_frame"])


def _timers():
    from obvi_slam_tpu_torch.timing import TimerRegistry

    return {k: v["total_s"] for k, v in TimerRegistry.instance().summary().items()}


def measure(ctx, seconds, tracer):
    from obvi_slam_tpu_torch.solver import lm_fused

    cuda = ctx["device"] == "cuda"
    sampler = ctx["sampler"]
    n_trace = ctx["workload"]["trace_frames"] if tracer.enabled else 0
    timers0, stats0 = _timers(), dict(lm_fused.graph_stats)
    frame_s, failed, traced = [], 0, 0
    first = ctx["next_frame"]
    sampler.active = True
    t0 = time.perf_counter()
    last = t0
    if n_trace:
        tracer.start()
    # The session's last frame runs the final BA's parameters: the window
    # stops before it.
    while ctx["next_frame"] < ctx["max_frame"]:
        t_frame = time.perf_counter()
        with harness.span("frame"):
            ok = _frame(ctx)
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if now - t0 > seconds:
            sampler.drop()
            break
        sampler.commit()
        frame_s.append(now - t_frame)
        failed += int(not ok)
        last = now
        if tracer.active:
            traced += 1
            if traced >= n_trace:
                tracer.stop()
    else:
        print(f"the window reached the session's last frame after {len(frame_s)} frames",
              file=sys.stderr)
    sampler.active = False
    if tracer.active:
        tracer.stop()
    window = last - t0
    if not frame_s:
        raise RuntimeError(f"no frame completed within {seconds} s")
    timers = {k: v - timers0.get(k, 0.0) for k, v in _timers().items()}
    stats = {k: v - stats0.get(k, 0) for k, v in lm_fused.graph_stats.items()
             if isinstance(v, (int, float))}
    print(f"window: frames {first}-{first + len(frame_s) - 1}, {len(frame_s)} frames in "
          f"{window:.4f} s", file=sys.stderr)
    return harness.Measured(
        e2e={"frames_per_s": len(frame_s) / window,
             "frame_ms_p90": float(np.percentile(np.array(frame_s) * 1e3, 90))},
        attempted=len(frame_s), failed=failed,
        record=dict(frames=len(frame_s), timers=timers, graph_stats=stats),
    )


def _host(x):
    return x.detach().cpu().numpy()


def _plain_arrays(state, cams, tables, free, weights):
    """The program's problem as the reference's flat arrays (float64)."""
    rp, bb, sh, rl, lt, pp = (tables.reproj, tables.bbox, tables.shape, tables.relpose,
                              tables.ltm, tables.param_prior)
    a = dict(
        poses=_host(state.poses), points=_host(state.points), objects=_host(state.objects),
        free_poses=_host(free.poses), free_points=_host(free.points),
        free_objects=_host(free.objects),
        cam_r=_host(cams.cam_from_robot_r), cam_t=_host(cams.cam_from_robot_t),
        reproj_pose=_host(rp.pose_idx), reproj_point=_host(rp.point_idx),
        reproj_cam=_host(rp.cam_idx), reproj_obs=_host(rp.rect_obs),
        reproj_mult=_host(rp.multiplier), reproj_mask=_host(rp.mask),
        bbox_obj=_host(bb.obj_idx), bbox_pose=_host(bb.pose_idx), bbox_cam=_host(bb.cam_idx),
        bbox_corners=_host(bb.rect_corners), bbox_sqrt_inf=_host(bb.sqrt_inf),
        bbox_mask=_host(bb.mask),
        shape_obj=_host(sh.obj_idx), shape_mean=_host(sh.mean_dim),
        shape_sqrt_inf=_host(sh.sqrt_inf), shape_mask=_host(sh.mask),
        relpose_before=_host(rl.before_idx), relpose_after=_host(rl.after_idx),
        relpose_t=_host(rl.meas_t), relpose_r=_host(rl.meas_r),
        relpose_sqrt_inf=_host(rl.sqrt_inf), relpose_mask=_host(rl.mask),
        ltm_obj=_host(lt.obj_idx), ltm_mean=_host(lt.mean), ltm_sqrt_inf=_host(lt.sqrt_inf),
        ltm_mask=_host(lt.mask),
        prior_kind=_host(pp.block_kind), prior_block=_host(pp.block_idx),
        prior_param=_host(pp.param_idx), prior_mean=_host(pp.mean),
        prior_inv_std=_host(pp.inv_std), prior_mask=_host(pp.mask),
    )
    if weights is not None:
        for fam in ("reproj", "bbox", "shape", "relpose", "ltm"):
            a[f"{fam}_w"] = _host(getattr(weights, fam))
    return {k: (v.astype(np.float64) if v.dtype.kind == "f" else v) for k, v in a.items()}


def _lm_settings(p):
    """The reference's LMSettings of the program's solver parameters (the
    program's defaults where the call gave none)."""
    if p is None:
        from obvi_slam_tpu_torch.solver.lm import LMParams

        p = LMParams()
    return ref_lm.LMSettings(max_iterations=int(p.max_num_iterations),
                             function_tolerance=float(p.function_tolerance),
                             initial_radius=float(p.initial_trust_region_radius),
                             max_radius=float(p.max_trust_region_radius))


def _huber(h):
    return dict(reproj=h.reproj, bbox=h.bbox, shape=h.shape, relpose=h.relpose, ltm=h.ltm,
                invalid_ellipse_error=h.invalid_ellipse_error)


def _two_phase_settings(problem, params):
    sc = problem.scope
    program = dict(
        feature_outlier_percentage=float(params.feature_outlier_percentage),
        min_low_level_feature_observations=int(sc.min_low_level_feature_observations),
        min_low_level_feature_observations_per_frame=int(
            sc.min_low_level_feature_observations_per_frame),
        min_object_observations=int(sc.min_object_observations),
        include_visual_factors=bool(sc.include_visual_factors),
        include_object_factors=bool(sc.include_object_factors),
        include_shape_priors=bool(sc.include_shape_priors),
        fix_objects=bool(sc.fix_objects), fix_ltm_objects=bool(sc.fix_ltm_objects),
        force_include_ltm_objs=bool(sc.force_include_ltm_objs),
    )
    return harness.two_phase_settings(program)


class RawIndex:
    """The raw inputs by key, for the table checks: pixels by (frame,
    feature, camera), rectified detections by (frame, camera)."""

    def __init__(self, raw):
        self.px = {(f, j, c): p for f, j, c, p in zip(raw.obs_frame.tolist(),
                                                      raw.obs_feat.tolist(),
                                                      raw.obs_cam.tolist(), raw.obs_px)}
        self.cams = {cid: (k, r, t) for cid, k, r, t in raw.cameras}
        self.dets = {}
        for f, c, p in zip(raw.det_frame.tolist(), raw.det_cam.tolist(), raw.det_px):
            k = self.cams[c][0]
            rect = np.array([(p[0] - k[0, 2]) / k[0, 0], (p[1] - k[0, 2]) / k[0, 0],
                             (p[2] - k[1, 2]) / k[1, 1], (p[3] - k[1, 2]) / k[1, 1]])
            self.dets.setdefault((f, c), []).append(rect)
        self.all_dets = np.concatenate([np.stack(v) for v in self.dets.values()]) \
            if self.dets else np.zeros((0, 4))


def _check_tables(a, index: RawIndex, pose_rows=None, point_rows=None, prior=None):
    """(rows of the program's tables that disagree with the raw inputs, rows
    checked): the cameras, each live reprojection row's rectified pixel
    (where the rows' frames and features are known), each live bounding-box
    row's rectified detection, and the shape priors' means and
    information."""
    bad = 0
    checked = len(index.cams) + int(a["bbox_mask"].sum()) + int(a["shape_mask"].sum())
    cam_ids = sorted(index.cams)
    for i, cid in enumerate(cam_ids):
        _, r, t = index.cams[cid]
        bad += int(not (np.allclose(a["cam_r"][i], r.T, atol=1e-6)
                        and np.allclose(a["cam_t"][i], -r.T @ t, atol=1e-6)))
    if pose_rows is not None and point_rows is not None:
        live = np.nonzero(a["reproj_mask"])[0]
        checked += len(live)
        for i in live.tolist():
            key = (int(pose_rows[a["reproj_pose"][i]]), int(point_rows[a["reproj_point"][i]]),
                   cam_ids[a["reproj_cam"][i]])
            px = index.px.get(key)
            if px is None:
                bad += 1
                continue
            k = index.cams[key[2]][0]
            want = np.array([(px[0] - k[0, 2]) / k[0, 0], (px[1] - k[1, 2]) / k[1, 1]])
            bad += int(np.max(np.abs(a["reproj_obs"][i] - want)) > 1e-5)
    live = np.nonzero(a["bbox_mask"])[0]
    for i in live.tolist():
        if pose_rows is not None:
            cands = index.dets.get((int(pose_rows[a["bbox_pose"][i]]),
                                    cam_ids[a["bbox_cam"][i]]), [])
            cands = np.stack(cands) if cands else np.zeros((0, 4))
        else:
            cands = index.all_dets
        if not len(cands) or np.min(np.max(np.abs(cands - a["bbox_corners"][i]), 1)) > 1e-5:
            bad += 1
    if prior is not None:
        mean, sqrt_inf = prior
        for i in np.nonzero(a["shape_mask"])[0].tolist():
            bad += int(not (np.allclose(a["shape_mean"][i], mean, atol=1e-6)
                            and np.allclose(a["shape_sqrt_inf"][i], sqrt_inf, rtol=1e-5)))
    return bad, checked


def release(ctx):
    """Frees the program's session and graphs; the sampled solves' inputs
    and answers go to the host."""
    from obvi_slam_tpu_torch.solver import lm_fused

    chair = ctx["config"]["port_config"]["shape_dimension_priors"][0]
    prior = (np.array(chair["mean"]), np.diag(1.0 / np.array(chair["std"])))
    cases = []
    for kind, r in ctx["sampler"].sample():
        if kind == "mini_ba":
            from obvi_slam_tpu_torch.solver.schur import HuberParams

            a = _plain_arrays(r["x0"], r["cams"], r["tables"], r["free"], r.get("weights"))
            huber, rows, tp = r["huber"] or HuberParams(), (None, None), None
        else:
            p = r["problem"]
            a = _plain_arrays(r["x0"], p.cams, p.tables, p.free,
                              p.weights if kind == "window_ba" else r["weights"])
            huber, rows = p.huber, (p.pose_rows, p.point_rows)
            tp = None
            if kind == "window_ba":
                tp = (_two_phase_settings(p, r["params"]), _host(p.aux.is_ltm_obj),
                      _host(p.aux.shape_live))
        out = tuple(_host(x).astype(np.float64) for x in (r["out"].poses, r["out"].objects,
                                                          r["out"].points))
        if kind == "window_ba":
            lm = (_lm_settings(r["params"].phase_one_opt_params),
                  _lm_settings(r["params"].phase_two_opt_params))
        else:
            lm = (_lm_settings(r["params"]),) * 2
        cases.append(dict(kind=kind, arrays=a, huber=_huber(huber), rows=rows, tp=tp, out=out,
                          prior=prior, lm=lm, first=r["first"]))
    ctx["cases"] = cases
    for obj, name, original in ctx.pop("restore"):
        setattr(obj, name, original)
    for key in ("session", "sampler"):
        ctx.pop(key, None)
    lm_fused.clear_graphs()
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()


def _solve_case(prob, case, settings1, settings2):
    """(state, phase-2 weights or None) of the reference's solve of a case:
    a two-phase case's phase 1 at ``settings1``, else ``settings2``."""
    device = prob.poses.device
    if case["tp"] is not None:
        tp, is_ltm, shape_live = case["tp"]
        live = case["arrays"]["shape_mask"].astype(bool)
        x, _, w, _ = ref_lm.two_phase(
            prob, tp, settings1, settings2,
            torch.as_tensor(is_ltm[prob.keep["objects"]], device=device),
            torch.as_tensor(shape_live[live], device=device))
        return x, w
    x, _, _ = ref_lm.solve(prob, prob.state(), None, settings2)
    return x, None


def judge_case(case, settings):
    """The reference's own float64 solve of one sampled problem (to the end
    of its descent, at least as many iterations as the program's; a window
    BA's phase 1 by the program's phase-one rule), and the share of its
    decrease that the program's answer misses."""
    settings = ref_lm.LMSettings(**dict(
        settings.__dict__, max_iterations=max(settings.max_iterations,
                                              *(p.max_iterations for p in case["lm"]))))
    prob = case["problem"]
    x_ref, w = _solve_case(prob, case, case["lm"][0], settings)
    return ref_lm.suboptimality(prob, prob.take(*case["out"]), x_ref, w)


def first_step_norm(case):
    """How far the norm of the program's first LM step lies from the norm
    of the reference's first float64 step from the same state, at the
    program's first-phase settings."""
    prob = case["problem"]
    _, _, norm_ref = ref_lm.first_step(prob, prob.state(), None, case["lm"][0])
    return ref_lm.norm_gap(case["first"][2], norm_ref)


def check(ctx, measured):
    t0 = time.perf_counter()
    settings = ref_lm.LMSettings(**ctx["workload"]["reference"])
    index = RawIndex(ctx["raw"])
    worst = {}
    mismatches = 0
    for case in ctx["cases"]:
        pose_rows, point_rows = case["rows"]
        bad, checked = _check_tables(case["arrays"], index, pose_rows, point_rows,
                                     case["prior"])
        mismatches += bad
        case["problem"] = build.plain_problem(case["arrays"], case["huber"],
                                              dtype=torch.float64, device=ctx["device"])
        values = {f"first_step_norm.{case['kind']}": first_step_norm(case),
                  f"suboptimality.{case['kind']}": judge_case(case, settings)}
        for name, v in values.items():
            worst[name] = max(worst.get(name, -float("inf")), v)
        print(f"reference: {case['kind']} {values}; {bad} of {checked} table rows differ "
              "from the raw inputs", file=sys.stderr)
        case.pop("problem")
    print(f"reference: {len(ctx['cases'])} solves in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    worst["table_mismatches"] = float(mismatches)
    return harness.checks_of(worst, ctx["workload"]["limits"])
