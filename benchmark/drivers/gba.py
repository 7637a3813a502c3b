"""Driver of the ``gba`` cells: the paper config's final global bundle
adjustment (its visual-feature BA over the whole map, at the final-BA
parameters ``final_ba``) on the map of a long session, as one two-phase
solve repeated.

Set-up draws the problem from the seed (``traffic/problem.py``), relabels
it out and back where the cell's traffic says so, turns it into the
program's tables and Schur plan with the program's own builders, and runs
``solve_two_phase_fused`` until its CUDA graphs are captured and replayed.
The window repeats that call, the one the runner makes on the final frame
on the card, from the same initial state, and times it by the host clock up
to the end of the last whole solve. ``gba_iter_ms`` is that time over the
LM iterations of both phases of the solves completed in it.

The solves return their iteration records (``with_records``, as the
runner's call does when the iteration logger is on). The check: the
reference (``reference/``) rebuilds the problem from the same arrays, runs
its own two-phase solve in float64 to the end of its descent, and judges
every state the window produced by the share of the reference's decrease
that it misses (``suboptimality``, under the reference's phase-2
selection), and every solve's first LM step by how far its norm lies from
the norm of the reference's first step from the same state and radius
(``first_step_norm``): the answer is the fixed point of the exact cost,
which a lower precision in the step leaves in place; the step is where it
shows.

A cell whose program takes no lower-precision path of its own (its
workload's ``"control": "reference_tf32"``) has ``reference_control`` for
its control: the reference put in the program's place, in float32 with the
operands of its Gauss-Newton products rounded to TF32.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import build, lm as ref_lm
from benchmark.traffic import problem as gen


# The configuration's keys that size the problem.
PROBLEM_KEYS = ("n_poses", "n_points", "n_objects", "obs_per_point", "obs_per_object",
                "noise_px", "pose_noise", "point_noise")


def make_problem(workload, config, seed):
    """The cell's raw arrays: the configuration's problem at the traffic's
    pose count, relabelled out and back for a loop-closure layout."""
    sizes = {k: config[k] for k in PROBLEM_KEYS}
    sizes.update(workload["traffic"].get("problem", {}))
    raw = gen.synthetic_problem(**sizes, seed=seed)
    if workload["traffic"]["layout"] == "out_and_back":
        raw = gen.out_and_back(raw)
    elif workload["traffic"]["layout"] != "band":
        raise ValueError(f"unknown layout {workload['traffic']['layout']!r}")
    return raw


def program_inputs(raw, config, device, dtype=np.float32):
    """The program's arguments of ``solve_two_phase_fused``, built from the
    raw arrays by the program's table and plan builders."""
    from obvi_slam_tpu_torch import types as T
    from obvi_slam_tpu_torch.solver import plan as plan_mod
    from obvi_slam_tpu_torch.solver.lm import LMParams
    from obvi_slam_tpu_torch.solver.schur import HuberParams, ones_weights
    from obvi_slam_tpu_torch.solver.two_phase import TwoPhaseAux, TwoPhaseConfig

    n_pose, n_obj = len(raw["poses"]), len(raw["objects"])
    cams = T.make_camera_bundle(np.eye(3)[None], np.zeros((1, 3)), [gen.FX], [gen.FY],
                                [gen.CX], [gen.CY], dtype, device)
    kw = dict(dtype=dtype, device=device)
    n_rp, n_bb = len(raw["reproj_pose"]), len(raw["bbox_obj"])
    tables = T.FactorTables(
        reproj=T.make_reprojection_factors(raw["reproj_pose"], raw["reproj_point"],
                                           np.zeros(n_rp, np.int64), raw["reproj_obs"],
                                           raw["reproj_mult"], **kw),
        bbox=T.make_bounding_box_factors(raw["bbox_obj"], raw["bbox_pose"],
                                         np.zeros(n_bb, np.int64), raw["bbox_corners"],
                                         raw["bbox_sqrt_inf"], **kw),
        shape=T.make_shape_prior_factors(raw["shape_obj"], raw["shape_mean"],
                                         raw["shape_sqrt_inf"], **kw),
        relpose=T.make_relative_pose_factors(raw["relpose_before"], raw["relpose_after"],
                                             raw["relpose_t"], raw["relpose_r"],
                                             raw["relpose_sqrt_inf"], **kw),
        ltm=T.empty_ltm_prior_factors(**kw),
        param_prior=T.empty_param_prior_factors(**kw),
    )
    plan = plan_mod.build_schur_plan_host(
        raw["reproj_pose"], raw["reproj_point"], tables.reproj.capacity, raw["bbox_pose"],
        raw["bbox_obj"], tables.bbox.capacity, n_pose=n_pose,
        rl_before=raw["relpose_before"], rl_after=raw["relpose_after"],
        rl_cap=tables.relpose.capacity, device=device,
    )

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    state = T.BAState(poses=t(raw["poses"].astype(dtype)), points=t(raw["points"].astype(dtype)),
                      objects=t(raw["objects"].astype(dtype)))
    free = T.FreeMasks(poses=t(raw["free_poses"]), points=t(np.ones(len(raw["points"]), bool)),
                       objects=t(np.ones(n_obj, bool)))
    weights = ones_weights(tables, dtype=state.poses.dtype)
    aux = TwoPhaseAux(is_ltm_obj=torch.zeros(n_obj, dtype=torch.bool, device=device),
                      shape_live=tables.shape.mask)
    gba = config["final_ba"]
    return (state, cams, tables, plan, free, weights, aux, LMParams(**gba["phase_one"]),
            LMParams(**gba["phase_two"]), HuberParams(**config["huber"]),
            TwoPhaseConfig(**gba["two_phase"]))


def setup(workload, config, seed, device):
    """The problem, the program's inputs, and every graph of the solve
    captured: the first call runs eagerly, the second captures, the rest
    replay."""
    from obvi_slam_tpu_torch import ops
    from obvi_slam_tpu_torch.solver.lm_fused import solve_two_phase_fused

    raw = make_problem(workload, config, seed)
    args = program_inputs(raw, config, device)
    k3_shapes = []

    def k3_operands(a, kw, out):
        w_rows, local_pose = a[:2]
        k3_shapes.append(tuple(w_rows.shape) + (local_pose.shape[-1], w_rows.element_size()))

    inner = harness.wrap(ops, "band_zbuild_gram", "k3", after=k3_operands)
    try:
        for _ in range(workload["warm_solves"]):
            solve_two_phase_fused(*args, with_records=True)
    finally:
        ops.band_zbuild_gram = inner
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(raw=raw, args=args, solve=solve_two_phase_fused, workload=workload,
                config=config, device=device, k3=k3_shapes[-1] if k3_shapes else None)


def measure(ctx, seconds, tracer):
    """Repeats the solve for ``seconds``; the first ``trace_solves`` solves
    of a traced run lie in the traced window."""
    from obvi_slam_tpu_torch.solver import lm_fused

    solve, args, cuda = ctx["solve"], ctx["args"], ctx["device"] == "cuda"
    n_trace = ctx["workload"]["trace_solves"] if tracer.enabled else 0
    states, firsts, iters, traced_iters, failed, most = [], [], 0, 0, 0, 0
    stats0 = dict(lm_fused.graph_stats)
    t0 = time.perf_counter()
    last = t0
    if n_trace:
        tracer.start()
    while True:
        with harness.span("two_phase_solve"):
            state, s1, s2 = solve(*args, with_records=True)
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if now - t0 > seconds:
            break
        last = now
        n = s1.num_iterations + s2.num_iterations
        if tracer.active:
            traced_iters += n
            if len(states) + 1 >= n_trace:
                tracer.stop()
        iters += n
        most = max(most, s1.num_iterations, s2.num_iterations)
        failed += int(not np.isfinite(s2.final_cost))
        states.append(state)
        firsts.append(harness.first_record(s1))
    window = last - t0
    if tracer.active:
        tracer.stop()
    if not states:
        raise RuntimeError(f"no solve completed within {seconds} s")
    stats = {k: v - stats0.get(k, 0) for k, v in lm_fused.graph_stats.items()
             if isinstance(v, (int, float))}
    ctx["states"], ctx["firsts"] = states, firsts
    return harness.Measured(
        e2e={"gba_iter_ms": window * 1e3 / iters},
        attempted=len(states), failed=failed,
        record=dict(iterations=iters, traced_iterations=traced_iters, graph_stats=stats,
                    k3=ctx["k3"], most_phase_iterations=most),
    )


def release(ctx):
    """Frees the program's state: its inputs and cached graphs."""
    from obvi_slam_tpu_torch.solver import lm_fused

    states = [tuple(x.detach().double().cpu() for x in (s.poses, s.objects, s.points))
              for s in ctx.pop("states", [])]
    ctx["states_host"] = states
    ctx.pop("args", None)
    lm_fused.clear_graphs()
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()


def reference(ctx):
    """The reference's float64 problem and its two-phase optimum:
    (problem, state, phase-2 weights, LM iterations)."""
    config, raw = ctx["config"], ctx["raw"]
    prob = build.plain_problem(raw, config["huber"], dtype=torch.float64, device=ctx["device"])
    settings = ref_lm.LMSettings(**ctx["workload"]["reference"])
    tp = harness.two_phase_settings(config["final_ba"]["two_phase"])
    no_ltm = torch.zeros(prob.objects.shape[0], dtype=torch.bool, device=ctx["device"])
    x, _, w2, its = ref_lm.two_phase(prob, tp, settings, settings, no_ltm,
                                     prob.factors["shape"]["mask"])
    return prob, x, w2, its


def program_settings(config, phase="phase_one"):
    """The reference's LMSettings at the program's parameters of a phase."""
    p = config["final_ba"][phase]
    return ref_lm.LMSettings(max_iterations=p["max_num_iterations"],
                             function_tolerance=p["function_tolerance"],
                             initial_radius=p["initial_trust_region_radius"],
                             max_radius=p["max_trust_region_radius"])


def first_step_norm(prob, settings, firsts):
    """The worst gap of the solves' first step norms (``firsts``: (cost,
    decrease, norm) each) from the norm of the reference's first phase-1
    step from the same state at the program's phase-1 settings."""
    _, _, norm_ref = ref_lm.first_step(prob, prob.state(), None, settings)
    return max(ref_lm.norm_gap(norm, norm_ref) for _, _, norm in firsts)


def judge(prob, x_ref, w2, states):
    """The worst share of the reference's decrease that the states miss."""
    worst = -float("inf")
    for s in states:
        worst = max(worst, ref_lm.suboptimality(prob, prob.take(*s), x_ref, w2))
    return worst


def check(ctx, measured):
    t0 = time.perf_counter()
    prob, x_ref, w2, its = reference(ctx)
    worst = judge(prob, x_ref, w2, ctx["states_host"])
    step = first_step_norm(prob, program_settings(ctx["config"]), ctx["firsts"])
    print(f"reference: {its} LM iterations in {time.perf_counter() - t0:.2f} s; "
          f"{len(ctx['states_host'])} states judged; the program's phases took at most "
          f"{measured.record['most_phase_iterations']} LM iterations", file=sys.stderr)
    return harness.checks_of({"suboptimality": worst, "first_step_norm": step},
                             ctx["workload"]["limits"])



def reference_control(workload, config, seed, device):
    """The control's readings {number: value}: the reference's two-phase
    solve in the program's place, in float32 with the operands of its
    Gauss-Newton products rounded to TF32 (``factors.tf32``), at the
    program's parameters, judged as the program's solves are."""
    from benchmark.reference import factors

    ctx = dict(raw=make_problem(workload, config, seed), config=config, workload=workload,
               device=device)
    low = build.plain_problem(ctx["raw"], config["huber"], dtype=torch.float32, device=device)
    tp = harness.two_phase_settings(config["final_ba"]["two_phase"])
    no_ltm = torch.zeros(low.objects.shape[0], dtype=torch.bool, device=device)
    factors.operand_rounding = factors.tf32
    try:
        _, _, norm = ref_lm.first_step(low, low.state(), None, program_settings(config))
        x, _, _, _ = ref_lm.two_phase(low, tp, program_settings(config),
                                      program_settings(config, "phase_two"), no_ltm,
                                      low.factors["shape"]["mask"])
    finally:
        factors.operand_rounding = None
    prob, x_ref, w2, _ = reference(ctx)
    state = tuple(t.double() for t in x)
    _, _, norm_ref = ref_lm.first_step(prob, prob.state(), None, program_settings(config))
    return {"suboptimality": ref_lm.suboptimality(prob, state, x_ref, w2),
            "first_step_norm": ref_lm.norm_gap(norm, norm_ref)}
