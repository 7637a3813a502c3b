#!/usr/bin/env python3
"""Smoke test of obvi_slam_tpu_torch on one NVIDIA H100.

Run from the repository root with one visible card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``obvi_slam_tpu_torch/ops/csrc`` with nvcc
(one nvcc per source, all at once) and holds each kernel against its plain
PyTorch version, in f32 and f64, at the shapes the main path gives it: K1
(reprojection) and K2 (bounding box) at the local-BA window's tables, K3
(banded z build + group gram) at the global problem's operands and K4 (syrk
gram) at the window's point gram. It checks one f32 step with the kernels
against an f64 step of the plain versions on both problems. Then it drives
the main path, two phases, each with the launch counts reset just before it:

  - ``global``: the two-phase global bundle adjustment of 256 poses x 4096
    points x 32 objects (the reference's bench problem, ``bench.py:95-105``),
    banded, through K1, K2 and K3; also a fixed 20-iteration LM solve with
    the tolerances at 0, as ``bench.py:124-129``;
  - ``window``: the two-phase sliding-window bundle adjustment of 64 poses x
    4096 points x 32 objects (the reference's default window of 50 frames at
    power-of-two capacity, with the bench problem's densities), dense,
    through K1, K2 and K4;

each checked against an f64 run of the plain versions. It prints LM
iterations/s, the kernels' times and launch counts, a profile of each phase,
one JSON line describing the kernels, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Any failed check raises:
the exit code is then non-zero and the last line is not printed. There is no
CPU path.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import obvi_slam_tpu_torch as ot  # noqa: E402
from obvi_slam_tpu_torch import factors as fac  # noqa: E402
from obvi_slam_tpu_torch import ops  # noqa: E402
from obvi_slam_tpu_torch.ops import _build, band_gram, syrk  # noqa: E402
from obvi_slam_tpu_torch.solver import (  # noqa: E402
    TERMINATION_NAMES,
    LMParams,
    TwoPhaseAux,
    TwoPhaseConfig,
    solve,
    solve_two_phase,
)

WINDOW = dict(n_poses=64, n_points=4096, n_objects=32, obs_per_point=6, obs_per_object=12, seed=0)
GLOBAL = dict(WINDOW, n_poses=256)
# Phases of the main path and the kernels each must launch.
PHASES = {
    "global": (GLOBAL, ("reproj", "bbox", "band_gram")),
    "window": (WINDOW, ("reproj", "bbox", "syrk")),
}
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and CUDA-core
# (non-tensor) float32 flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Floating-point operations per live factor, counted from the kernel sources.
FLOPS_PER_FACTOR = {"reproj": 212, "bbox": 3360}
KERNELS = {
    "reproj": dict(
        source="obvi_slam_tpu_torch/ops/csrc/reproj.cu",
        replaces="obvi_slam_tpu/ops/reproj_pallas.py:54",
    ),
    "bbox": dict(
        source="obvi_slam_tpu_torch/ops/csrc/bbox.cu",
        replaces="obvi_slam_tpu/ops/bbox_pallas.py:59",
    ),
    "band_gram": dict(
        source="obvi_slam_tpu_torch/ops/csrc/band_gram.cu",
        replaces="obvi_slam_tpu/ops/band_gram_pallas.py:53",
    ),
    "syrk": dict(
        source="obvi_slam_tpu_torch/ops/csrc/syrk.cu",
        replaces="obvi_slam_tpu/ops/syrk_pallas.py:91",
    ),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def preconditions():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA card")
    print(f"card: {card_line()}")
    nvcc = _build.nvcc_path()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc {nvcc}: {version}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def build():
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


# ---- kernels against their plain versions --------------------------------


def _padded_with_garbage(table, n_extra):
    """The table plus ``n_extra`` masked rows copied from live rows."""
    fields = {}
    for name, col in table._asdict().items():
        extra = torch.zeros_like(col[:n_extra]) if name == "mask" else col[:n_extra]
        fields[name] = torch.cat([col, extra]).contiguous()
    return type(table)(**fields)


def _compare(name, kernel_out, plain_out, dtype, live=None, gram=False):
    """Max abs error over the outputs; raises past the stated tolerance: f64
    rtol 1e-9 with an absolute floor of 1e-11 (for the grams, of 1e-12 of the
    output's largest entry, where long sums cancel), f32 1e-4 of each
    output's largest entry. With ``live``, masked rows must be exactly 0."""
    worst = 0.0
    for k, (a, b) in enumerate(zip(kernel_out, plain_out)):
        if live is not None and not bool((a[~live] == 0).all()):
            raise AssertionError(f"{name} output {k}: masked rows not exactly zero")
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if dtype == torch.float64:
            floor = max(1e-11, 1e-12 * float(b.abs().max())) if gram else 1e-11
            bad = err > floor + 1e-9 * b.abs()
            if bool(bad.any()):
                raise AssertionError(
                    f"{name} f64 output {k}: {int(bad.sum())} entries past rtol 1e-9, "
                    f"atol {floor:.1e} (max abs err {float(err.max()):.3e})"
                )
        else:
            limit = 1e-4 * float(b.abs().max())
            if float(err.max()) > limit:
                raise AssertionError(
                    f"{name} f32 output {k}: max abs err {float(err.max()):.3e} > {limit:.3e}"
                )
    return worst


def _saturated(state):
    """Object 0 moved onto pose 0 and blown up: the camera sits inside it."""
    objects = state.objects.clone()
    objects[0, :3] = state.poses[0, :3]
    objects[0, 4:7] = 50.0
    return state._replace(objects=objects)


def problem(dtype, size=WINDOW):
    return ot.synthetic_problem(**size, dtype=dtype, device=DEVICE)


def check_kernels(np_dtype):
    """K1 and K2 against their plain versions at window shapes; returns the
    max abs error per kernel."""
    state, _, cams, tables, *_ = problem(np_dtype)
    dtype = state.poses.dtype
    reproj = _padded_with_garbage(tables.reproj, 300)
    bbox = _padded_with_garbage(tables.bbox, 30)
    errs = {}
    out_k = ops.reproj_residuals_and_jac(state, cams, reproj)
    out_p = fac.reproj_residuals_and_jac_fast(state, cams, reproj)
    torch.cuda.synchronize()
    errs["reproj"] = _compare("reproj", out_k, out_p, dtype, reproj.mask)
    out_k = ops.bbox_residuals_and_jac(state, cams, bbox)
    out_p = fac.bbox_residuals_and_jac(state, cams, bbox)
    torch.cuda.synchronize()
    errs["bbox"] = _compare("bbox", out_k, out_p, dtype, bbox.mask)
    sat = _saturated(state)
    out_k = ops.bbox_residuals_and_jac(sat, cams, bbox)
    out_p = fac.bbox_residuals_and_jac(sat, cams, bbox)
    torch.cuda.synchronize()
    invalid = bbox.mask & (out_p[0] == 1e6).all(1)
    if not bool(invalid.any()):
        raise AssertionError("saturation case produced no invalid projection")
    if not (bool((out_k[0][invalid] == 1e6).all()) and bool((out_k[1][invalid] == 0).all())
            and bool((out_k[2][invalid] == 0).all())):
        raise AssertionError("bbox kernel: invalid rows not saturated with zero Jacobians")
    errs["bbox"] = max(errs["bbox"], _compare("bbox saturated", out_k, out_p, dtype, bbox.mask))
    print(
        f"kernels vs plain {str(dtype).split('.')[-1]}: reproj max abs err "
        f"{errs['reproj']:.3e}, bbox max abs err {errs['bbox']:.3e} "
        f"({int(invalid.sum())} saturated rows) - ok"
    )
    return errs


def captured_operands(size, np_dtype, name):
    """The arguments that one compute_step on ``size``'s problem hands the
    ops wrapper ``name`` (the shapes and values of the main path)."""
    seen = []
    inner = getattr(ops, name)

    def spy(*args):
        seen.append(args)
        return inner(*args)

    setattr(ops, name, spy)
    try:
        state, _, cams, tables, plan, free, weights, huber = problem(np_dtype, size)
        ot.compute_step(state, cams, tables, plan, free, weights, 1e4, huber)
    finally:
        setattr(ops, name, inner)
    if len(seen) != 1:
        raise AssertionError(f"compute_step called {name} {len(seen)} times, expected 1")
    return seen[0]


def check_grams(np_dtype):
    """K3 at the global problem's operands and K4 at the window's against
    their plain versions; both grams must come out exactly symmetric and
    K3's z rows of dead slots exactly 0. Returns (errors, operands)."""
    w_rows, local_pose = captured_operands(GLOBAL, np_dtype, "band_zbuild_gram")
    (c,) = captured_operands(WINDOW, np_dtype, "syrk_gram")
    dtype = w_rows.dtype
    z, s = band_gram.launch(w_rows, local_pose)
    out_p = band_gram.band_zbuild_gram_plain(w_rows, local_pose)
    s4 = syrk.launch(c)
    torch.cuda.synchronize()
    dead = (local_pose >= band_gram.WIDTH).all(-1)
    if not bool((z[dead] == 0).all()):
        raise AssertionError("band_gram kernel: z rows of dead slots not exactly zero")
    if not (bool((s == s.transpose(1, 2)).all()) and bool((s4 == s4.T).all())):
        raise AssertionError("gram kernels: output not exactly symmetric")
    errs = {
        "band_gram": _compare("band_gram", (z, s), out_p, dtype, gram=True),
        "syrk": _compare("syrk", (s4,), (syrk.syrk_gram_plain(c),), dtype, gram=True),
    }
    print(
        f"grams vs plain {str(dtype).split('.')[-1]}: band_gram (w_rows "
        f"{tuple(w_rows.shape)}, {int(dead.sum())} dead rows) max abs err "
        f"{errs['band_gram']:.3e} (largest |s| {float(out_p[1].abs().max()):.3e}); syrk "
        f"(c {tuple(c.shape)}) max abs err {errs['syrk']:.3e} (largest |S| "
        f"{float(s4.abs().max()):.3e}) - ok"
    )
    return errs, {"band_gram": (w_rows, local_pose), "syrk": (c,)}


# ---- one step, f32 kernels against f64 plain ------------------------------


def rel(a, b):
    return float((a.double() - b.double()).norm() / (b.double().norm() + 1e-30))


def check_step(label):
    size = PHASES[label][0]
    steps = {}
    for dtype, plain in ((np.float64, True), (np.float32, False)):
        state, _, cams, tables, plan, free, weights, huber = problem(dtype, size)
        steps[dtype] = ot.compute_step(
            state, cams, tables, plan, free, weights, 1e4, huber, plain=plain
        )
    torch.cuda.synchronize()
    banded = plan.pt_band_local_pose is not None
    (d64, mc64, _), (d32, mc32, _) = steps[np.float64], steps[np.float32]
    errs = {
        "poses": rel(d32.poses, d64.poses),
        "points": rel(d32.points, d64.points),
        "objects": rel(d32.objects, d64.objects),
        "model_cost_change": abs(float(mc32) - float(mc64)) / abs(float(mc64)),
    }
    print(
        f"{label} step ({'banded' if banded else 'dense'}) f32 (kernels) vs f64 (plain): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    )
    for k in ("poses", "points", "model_cost_change"):
        if not errs[k] <= 5e-3:
            raise AssertionError(f"{label} f32 step {k} relative error {errs[k]:.3e} > 5e-3")


# ---- the main path: two-phase solves --------------------------------------


def run_two_phase(problem, plain):
    state, _, cams, tables, plan, free, weights, huber = problem
    aux = TwoPhaseAux(
        is_ltm_obj=torch.zeros(state.objects.shape[0], dtype=torch.bool, device=state.objects.device),
        shape_live=tables.shape.mask,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, s1, s2 = solve_two_phase(
        state, cams, tables, plan, free, weights, aux, LMParams(), LMParams(), huber,
        TwoPhaseConfig(), plain=plain,
    )
    torch.cuda.synchronize()
    return final, s1, s2, time.perf_counter() - t0


def check_result(final, summaries, what):
    for name, x in final._asdict().items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    for k, s in enumerate(summaries, 1):
        if s.termination not in TERMINATION_NAMES.values():
            raise AssertionError(f"{what} phase {k}: termination {s.termination}")
        if not (math.isfinite(s.initial_cost) and math.isfinite(s.final_cost)):
            raise AssertionError(f"{what} phase {k}: non-finite cost")
        if not s.final_cost < s.initial_cost:
            raise AssertionError(f"{what} phase {k}: cost did not fall")
        print(
            f"{what} phase {k}: {s.num_iterations} iterations "
            f"({s.num_successful_steps} accepted), {s.termination}, "
            f"cost {s.initial_cost:.6e} -> {s.final_cost:.6e}"
        )


def main_path_phase(label):
    """One warm-up solve, then the measured one between a reset and a read
    of the launch counts; then the f64 plain reference."""
    size, expected = PHASES[label]
    problem32 = problem(np.float32, size)
    run_two_phase(problem32, plain=False)  # warm-up: allocator, cuBLAS/cuSOLVER handles

    ops.reset_kernel_launches()
    final, s1, s2, wall = run_two_phase(problem32, plain=False)
    launches = ops.kernel_launches()

    check_result(final, (s1, s2), f"{label} f32 kernels")
    iters = s1.num_iterations + s2.num_iterations
    print(f"{label}: {iters} LM iterations in {wall:.4f} s wall, "
          f"{iters / wall:.2f} LM iterations/s")
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the {label} phase")
    print(f"{label} launches: {launches}")

    problem64 = problem(np.float64, size)
    final64, r1, r2, wall64 = run_two_phase(problem64, plain=True)
    check_result(final64, (r1, r2), f"{label} f64 plain")
    print(f"{label} f64 plain: {wall64:.4f} s wall")
    gap = abs(s2.final_cost - r2.final_cost) / r2.final_cost
    print(f"{label} final cost f32 kernels vs f64 plain: relative gap {gap:.3e}")
    if not gap <= 1e-3:
        raise AssertionError(f"{label} final cost gap {gap:.3e} > 1e-3")
    return dict(launches=launches, iters=iters, wall=wall)


def fixed_iterations(label, n_iters=20, runs=3):
    """LM iterations/s over fixed-length solves (tolerances at 0), so that
    the rate does not ride on the run-to-run iteration count; the median of
    ``runs`` solves, each from the same start."""
    state, _, cams, tables, plan, free, weights, huber = problem(np.float32, PHASES[label][0])
    params = LMParams(
        max_num_iterations=n_iters, function_tolerance=0.0, gradient_tolerance=0.0,
        parameter_tolerance=0.0,
    )
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, summary = solve(state, cams, tables, plan, free, weights, params, huber)
        torch.cuda.synchronize()
        rates.append(summary.num_iterations / (time.perf_counter() - t0))
    check_result(final, (summary,), f"{label} fixed {n_iters}-iteration solve")
    print(
        f"{label} fixed solve: {summary.num_iterations} LM iterations per solve, "
        f"{statistics.median(rates):.2f} LM iterations/s (median of "
        + ", ".join(f"{r:.2f}" for r in rates) + ")"
    )


# ---- timing ---------------------------------------------------------------


def time_ms(fn, inner=20, reps=9):
    """Median milliseconds per call over ``reps`` runs of ``inner`` calls,
    CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def device_ms(fn, match=None, calls=20):
    """Device time per call from torch.profiler: the self time of the device
    kernels whose name contains ``match`` (all of them when None), summed
    over ``calls`` calls. 0.0 when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and (match is None or match in e.key)
    )
    return total_us / 1e3 / calls


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _gram_flops(z):
    """Flops of the lower triangle of z^T z (diagonal included) over the
    rows' non-zeros: nnz (nnz + 1) per row, one multiply-add per product."""
    nnz = (z != 0).reshape(-1, z.shape[-1]).sum(1).double()
    return int((nnz * (nnz + 1)).sum())


def time_kernels(errs, phases, gram_ops):
    """Each kernel alone, its wrapper and its plain version, at the main
    path's shapes in f32: K1 and K2 on the window's tables (prebuilt gather
    tables), K3 on the global problem's operands, K4 on the window's point
    gram. Device times come from the profiler; CUDA-event times of
    back-to-back calls are also printed: they measure the host's issue rate
    when it is the slower side. The grams' bounds count the products of the
    rows' non-zeros (this run's data); the dense count is printed beside."""
    from obvi_slam_tpu_torch.ops import bbox as k_bbox
    from obvi_slam_tpu_torch.ops import reproj as k_reproj

    state, _, cams, tables, *_ = problem(np.float32)
    pose_tab = k_reproj.pose_table(state.poses)
    cam_tab = k_reproj.camera_table(cams)
    rp, bb = tables.reproj, tables.bbox
    w_rows, local_pose = gram_ops["band_gram"]
    (c,) = gram_ops["syrk"]
    z, _ = band_gram.launch(w_rows, local_pose)
    g_k3, k_k3 = z.shape[0], z.shape[1]
    m_k4 = c.shape[1]
    cases = {
        "reproj": (
            lambda: k_reproj.launch(pose_tab, state.points, cam_tab, rp),
            lambda: ops.reproj_residuals_and_jac(state, cams, rp),
            lambda: fac.reproj_residuals_and_jac_fast(state, cams, rp),
            None,
            (pose_tab, state.points, cam_tab, rp.pose_idx, rp.point_idx, rp.cam_idx,
             rp.rect_obs, rp.multiplier, rp.mask),
            FLOPS_PER_FACTOR["reproj"] * int(rp.mask.sum()), None,
        ),
        "bbox": (
            lambda: k_bbox.launch(state.objects, pose_tab, cam_tab, bb),
            lambda: ops.bbox_residuals_and_jac(state, cams, bb),
            lambda: fac.bbox_residuals_and_jac(state, cams, bb),
            None,
            (state.objects, pose_tab, cam_tab, bb.obj_idx, bb.pose_idx, bb.cam_idx,
             bb.rect_corners, bb.sqrt_inf, bb.mask),
            FLOPS_PER_FACTOR["bbox"] * int(bb.mask.sum()), None,
        ),
        "band_gram": (
            lambda: band_gram.launch(w_rows, local_pose),
            lambda: ops.band_zbuild_gram(w_rows, local_pose),
            lambda: band_gram.band_zbuild_gram_plain(w_rows, local_pose),
            lambda: torch.bmm(z.transpose(1, 2), z),
            (w_rows, local_pose),
            _gram_flops(z), g_k3 * k_k3 * band_gram.WBAND * (band_gram.WBAND + 1),
        ),
        "syrk": (
            lambda: syrk.launch(c),
            lambda: ops.syrk_gram(c),
            lambda: syrk.syrk_gram_plain(c),
            lambda: c.T @ c,
            (c,),
            _gram_flops(c), c.shape[0] * m_k4 * (m_k4 + 1),
        ),
    }
    launches = {
        name: sum(ph["launches"][name] for ph in phases.values()) for name in cases
    }
    rows = []
    for name, (kernel, wrapper, plain, library, inputs, flops, dense_flops) in cases.items():
        out = kernel()
        out = out if isinstance(out, tuple) else (out,)
        bytes_moved = _nbytes(*inputs) + _nbytes(*out)
        byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        flop_ms = flops / F32_FLOPS_PER_S * 1e3
        event_ms = time_ms(kernel)
        wrapper_event_ms = time_ms(wrapper)
        plain_event_ms = time_ms(plain, inner=5, reps=5)
        ms = device_ms(kernel, match=f"{name}_kernel")
        plain_ms = device_ms(plain, calls=5)
        library_ms = None if library is None else device_ms(library, calls=5)
        source = "profiler device time"
        if ms <= 0 or plain_ms <= 0:
            ms, plain_ms, source = event_ms, plain_event_ms, "CUDA events (profiler saw no device time)"
            library_ms = None if library is None else time_ms(library, inner=5, reps=5)
        iters = sum(ph["iters"] for ph in phases.values() if ph["launches"][name])
        by_phase = {label: ph["launches"][name] for label, ph in phases.items()}
        dense = ""
        if dense_flops is not None:
            dense = (f"; dense gram {dense_flops} flop, "
                     f"{dense_flops / F32_FLOPS_PER_S * 1e6:.3f} us at 67 TFLOP/s")
        library_txt = "none" if library_ms is None else f"{library_ms:.5f} ms"
        print(
            f"kernel {name}: {ms:.5f} ms per launch, plain version {plain_ms:.5f} ms per "
            f"call, library {library_txt} ({source}); back-to-back CUDA events: kernel "
            f"{event_ms:.4f} ms, wrapper {wrapper_event_ms:.4f} ms, plain "
            f"{plain_event_ms:.4f} ms; bound {max(byte_ms, flop_ms) * 1e3:.3f} us "
            f"({bytes_moved} B at 3.35 TB/s, {flops} flop{dense}); launches {by_phase}, "
            f"{launches[name] / iters:.2f} per LM iteration"
        )
        row = dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, flop_ms),
            bound_by="bytes" if byte_ms >= flop_ms else "operations",
            library_ms=library_ms, launches_by_phase=by_phase,
            launches_per_iteration=launches[name] / iters, event_ms=event_ms,
            wrapper_event_ms=wrapper_event_ms, plain_event_ms=plain_event_ms,
        )
        if dense_flops is not None:
            row["dense_flop_bound_ms"] = dense_flops / F32_FLOPS_PER_S * 1e3
        rows.append(row)
    return rows


def profile_phase(label, phase):
    """One more f32 two-phase solve of the phase under torch.profiler: device
    busy time per LM iteration against the wall time per LM iteration of the
    unprofiled main-path run (the two runs' iteration counts differ: f32
    sums on the card change order from run to run), and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    problem32 = problem(np.float32, PHASES[label][0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, s1, s2, prof_wall = run_two_phase(problem32, plain=False)
    iters = s1.num_iterations + s2.num_iterations
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    if busy_ms <= 0:
        print(f"profile {label}: the profiler saw no device time; busy share not measured")
        return
    wall_ms_per_iter = phase["wall"] * 1e3 / phase["iters"]
    print(
        f"profile {label}: {iters} LM iterations; device busy {busy_ms:.2f} ms, "
        f"{busy_ms / iters:.3f} ms per LM iteration; {n_kernels} device kernels "
        f"({n_kernels / iters:.0f} per LM iteration); busy share "
        f"{busy_ms / iters / wall_ms_per_iter:.4f} of the unprofiled "
        f"{wall_ms_per_iter:.3f} ms per LM iteration (profiled wall {prof_wall:.4f} s)"
    )
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def main():
    t_start = time.perf_counter()
    preconditions()
    build()
    check_kernels(np.float64)
    errs = check_kernels(np.float32)
    check_grams(np.float64)
    gram_errs, gram_ops = check_grams(np.float32)
    errs.update(gram_errs)
    for label in PHASES:
        check_step(label)
    phases = {label: main_path_phase(label) for label in PHASES}
    fixed_iterations("global")
    rows = time_kernels(errs, phases, gram_ops)
    for label, ph in phases.items():
        profile_phase(label, ph)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
