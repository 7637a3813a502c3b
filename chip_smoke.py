#!/usr/bin/env python3
"""Smoke test of obvi_slam_tpu_torch on one NVIDIA H100.

Run from the repository root with one visible card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``obvi_slam_tpu_torch/ops/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the shapes of the
local-BA window (f32 and f64), checks one f32 step against an f64 step, then
drives the main path once: a two-phase sliding-window bundle adjustment of
64 poses x 4096 points x 32 objects (the reference's default window of 50
frames at power-of-two capacity, with the point and object densities of its
256-pose bench problem), checked against an f64 run of the plain versions.
It prints the kernels' times and launch counts, one JSON line describing the
kernels, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. There is no CPU path.
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
from obvi_slam_tpu_torch.ops import _build  # noqa: E402
from obvi_slam_tpu_torch.solver import (  # noqa: E402
    TERMINATION_NAMES,
    LMParams,
    TwoPhaseAux,
    TwoPhaseConfig,
    solve_two_phase,
)

WINDOW = dict(n_poses=64, n_points=4096, n_objects=32, obs_per_point=6, obs_per_object=12, seed=0)
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


def _compare(name, kernel_out, plain_out, dtype, live):
    """Max abs error over the outputs; raises past the stated tolerance."""
    worst = 0.0
    for k, (a, b) in enumerate(zip(kernel_out, plain_out)):
        if not bool((a[~live] == 0).all()):
            raise AssertionError(f"{name} output {k}: masked rows not exactly zero")
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if dtype == torch.float64:
            bad = err > 1e-11 + 1e-9 * b.abs()
            if bool(bad.any()):
                raise AssertionError(
                    f"{name} f64 output {k}: {int(bad.sum())} entries past rtol 1e-9, "
                    f"atol 1e-11 (max abs err {float(err.max()):.3e})"
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


def problem(dtype):
    return ot.synthetic_problem(**WINDOW, dtype=dtype, device=DEVICE)


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


# ---- one step, f32 kernels against f64 plain ------------------------------


def rel(a, b):
    return float((a.double() - b.double()).norm() / (b.double().norm() + 1e-30))


def check_step():
    steps = {}
    for dtype, plain in ((np.float64, True), (np.float32, False)):
        state, _, cams, tables, plan, free, weights, huber = problem(dtype)
        steps[dtype] = ot.compute_step(
            state, cams, tables, plan, free, weights, 1e4, huber, plain=plain
        )
    torch.cuda.synchronize()
    (d64, mc64, _), (d32, mc32, _) = steps[np.float64], steps[np.float32]
    errs = {
        "poses": rel(d32.poses, d64.poses),
        "points": rel(d32.points, d64.points),
        "objects": rel(d32.objects, d64.objects),
        "model_cost_change": abs(float(mc32) - float(mc64)) / abs(float(mc64)),
    }
    print("step f32 (kernels) vs f64 (plain): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k in ("poses", "points", "model_cost_change"):
        if not errs[k] <= 5e-3:
            raise AssertionError(f"f32 step {k} relative error {errs[k]:.3e} > 5e-3")


# ---- the main path: one two-phase window ----------------------------------


def run_window(problem, plain):
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


def check_window_result(final, s1, s2, what):
    for name, x in final._asdict().items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    for k, s in ((1, s1), (2, s2)):
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


def window():
    problem32 = problem(np.float32)
    run_window(problem32, plain=False)  # warm-up: allocator, cuBLAS/cuSOLVER handles

    ops.reset_kernel_launches()
    final, s1, s2, wall = run_window(problem32, plain=False)
    launches = ops.kernel_launches()

    check_window_result(final, s1, s2, "window f32 kernels")
    iters = s1.num_iterations + s2.num_iterations
    print(f"window: {iters} LM iterations in {wall:.4f} s wall, {iters / wall:.2f} LM iterations/s")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    print(f"launches on the main path: {launches}")

    problem64 = problem(np.float64)
    final64, r1, r2, wall64 = run_window(problem64, plain=True)
    check_window_result(final64, r1, r2, "window f64 plain")
    print(f"window f64 plain: {wall64:.4f} s wall")
    gap = abs(s2.final_cost - r2.final_cost) / r2.final_cost
    print(f"final cost f32 kernels vs f64 plain: relative gap {gap:.3e}")
    if not gap <= 1e-3:
        raise AssertionError(f"final cost gap {gap:.3e} > 1e-3")
    return launches, iters, wall


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


def time_kernels(errs, launches, iters):
    """Each kernel alone (prebuilt gather tables), its wrapper (tables
    included) and its plain version, at window shapes in f32. Device times
    come from the profiler; CUDA-event times of back-to-back calls are also
    printed: they measure the host's issue rate when it is the slower side."""
    from obvi_slam_tpu_torch.ops import bbox as k_bbox
    from obvi_slam_tpu_torch.ops import reproj as k_reproj

    state, _, cams, tables, *_ = problem(np.float32)
    pose_tab = k_reproj.pose_table(state.poses)
    cam_tab = k_reproj.camera_table(cams)
    rp, bb = tables.reproj, tables.bbox
    cases = {
        "reproj": (
            lambda: k_reproj.launch(pose_tab, state.points, cam_tab, rp),
            lambda: ops.reproj_residuals_and_jac(state, cams, rp),
            lambda: fac.reproj_residuals_and_jac_fast(state, cams, rp),
            (pose_tab, state.points, cam_tab, rp.pose_idx, rp.point_idx, rp.cam_idx,
             rp.rect_obs, rp.multiplier, rp.mask),
            int(rp.mask.sum()),
        ),
        "bbox": (
            lambda: k_bbox.launch(state.objects, pose_tab, cam_tab, bb),
            lambda: ops.bbox_residuals_and_jac(state, cams, bb),
            lambda: fac.bbox_residuals_and_jac(state, cams, bb),
            (state.objects, pose_tab, cam_tab, bb.obj_idx, bb.pose_idx, bb.cam_idx,
             bb.rect_corners, bb.sqrt_inf, bb.mask),
            int(bb.mask.sum()),
        ),
    }
    rows = []
    for name, (kernel, wrapper, plain, inputs, live) in cases.items():
        out = kernel()
        bytes_moved = _nbytes(*inputs) + _nbytes(*out)
        flops = FLOPS_PER_FACTOR[name] * live
        byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        flop_ms = flops / F32_FLOPS_PER_S * 1e3
        event_ms = time_ms(kernel)
        wrapper_event_ms = time_ms(wrapper)
        plain_event_ms = time_ms(plain, inner=5, reps=5)
        ms = device_ms(kernel, match=f"{name}_kernel")
        plain_ms = device_ms(plain, calls=5)
        source = "profiler device time"
        if ms <= 0 or plain_ms <= 0:
            ms, plain_ms, source = event_ms, plain_event_ms, "CUDA events (profiler saw no device time)"
        per_iter = launches[name] / iters
        print(
            f"kernel {name}: {ms:.5f} ms per launch, plain version {plain_ms:.5f} ms per "
            f"call ({source}); back-to-back CUDA events: kernel {event_ms:.4f} ms, "
            f"wrapper with gather tables {wrapper_event_ms:.4f} ms, plain "
            f"{plain_event_ms:.4f} ms; bound {max(byte_ms, flop_ms) * 1e3:.3f} us "
            f"({bytes_moved} B at 3.35 TB/s, {flops} flop); {live} live factors; "
            f"{per_iter:.2f} launches per LM iteration"
        )
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, flop_ms),
            bound_by="bytes" if byte_ms >= flop_ms else "operations",
            library_ms=None, event_ms=event_ms, wrapper_event_ms=wrapper_event_ms,
            plain_event_ms=plain_event_ms,
        ))
    return rows


def profile_window(wall):
    """One more f32 window under torch.profiler: device busy time against
    the unprofiled wall time of the main-path run, and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    problem32 = problem(np.float32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, s1, s2, prof_wall = run_window(problem32, plain=False)
    iters = s1.num_iterations + s2.num_iterations
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    if busy_ms <= 0:
        print("profile: the profiler saw no device time; busy share not measured")
        return
    print(
        f"profile: {iters} LM iterations; device busy {busy_ms:.2f} ms, "
        f"{n_kernels} device kernels ({n_kernels / iters:.0f} per LM iteration); "
        f"busy share {busy_ms / 1e3 / wall:.4f} of the unprofiled wall {wall:.4f} s "
        f"(profiled wall {prof_wall:.4f} s)"
    )
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def main():
    preconditions()
    build()
    check_kernels(np.float64)
    errs = check_kernels(np.float32)
    check_step()
    launches, iters, wall = window()
    rows = time_kernels(errs, launches, iters)
    profile_window(wall)
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
