#!/usr/bin/env python3
"""Smoke test of obvi_slam_tpu_torch on one NVIDIA H100.

Run from the repository root with one visible card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``obvi_slam_tpu_torch/ops/csrc`` with nvcc
(one nvcc per source, all at once), prints each kernel's registers and
spills as ptxas reports them, and holds each kernel against its plain
PyTorch version, in f32 and f64, at the shapes the main path gives it: K1
(reprojection) and K2 (bounding box) at the synthetic phases' tables, also
at a ragged factor count, n = 1, n = 0, with every row masked, with every
other row on a second camera at a 0.12 m baseline, twice bit for bit and
(K1, f64) at a camera depth of exactly 0; K1 also at the session's largest
(stereo) table; K3 (banded z build + group
gram) at the global problem's operands and K4 (syrk gram) at the window's
point gram; K3 and K4 also on operands off the main path (dense and
permuted C, local poses across the whole window, repeated poses, dead slots
and rows, ragged and empty shapes), twice bit for bit, with the blocks each
launches and the rows each output tile multiplies. It checks one f32 step
with the kernels against an f64 step of the plain versions on the three
synthetic problems, and the f64 band-solve step against the f64 dense step
at 1,024 poses (cyclic reduction) and at 256 poses with the gate forced on
(the sequential tile loop). Then it drives the main path, four phases, each with the
launch counts reset just before it:

  - ``global``: the two-phase global bundle adjustment of 256 poses x 4096
    points x 32 objects (the reference's bench problem, ``bench.py:95-105``),
    banded, through K1, K2 and K3; also a fixed 20-iteration LM solve with
    the tolerances at 0, as ``bench.py:124-129``;
  - ``window``: the two-phase sliding-window bundle adjustment of 64 poses x
    4096 points x 32 objects (the reference's default window of 50 frames at
    power-of-two capacity, with the bench problem's densities), dense,
    through K1, K2 and K4;
  - ``scale_1024``: the two-phase global bundle adjustment of 1024 poses x
    16384 points x 64 objects (the reference's scale tier,
    ``bench.py:401-408``), through K1, K2, K3 and the block-tridiagonal +
    Woodbury band solve (counted by a spy); also a fixed 10-iteration solve;

each checked against an f64 run of the plain versions (phase 2 with the f32
run's outlier selection) and against an f64 run that selects its own,
whose selection may differ in at most 5% of the excluded factors; and

  - ``session``: ``OfflineProblemRunner.run_optimization`` on a 64-frame
    visual-only stereo session (``synthetic_session``) at the reference's
    default config (window 50, global BA every 30 frames), in f32 through K1
    and K4, checked by its trajectory error against the odometry's and
    against an f64 run of the plain versions.

It prints LM iterations/s, the session's frames/s and ms per frame, the
kernels' times, bounds and launch counts (K1 and K2 also with the device
kernels per wrapper call, which must be 1, and the launch floor: a
one-element ``torch.add``), each kernel also at the larger phases' shapes,
a profile of each synthetic phase (with the band solve's share at 1,024
poses) and of the session's last 8 frames, one JSON line describing the
kernels, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. There is no CPU path.
"""

from __future__ import annotations

import json
import math
import re
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
from obvi_slam_tpu_torch.ops import bbox as k_bbox  # noqa: E402
from obvi_slam_tpu_torch.ops import reproj as k_reproj  # noqa: E402
from obvi_slam_tpu_torch.ops._gram import lower_pair  # noqa: E402
from obvi_slam_tpu_torch.timing import TimerRegistry  # noqa: E402
from obvi_slam_tpu_torch.runner import visual_frontend_for  # noqa: E402
from obvi_slam_tpu_torch.solver import band_solve  # noqa: E402
from obvi_slam_tpu_torch.solver import schur as schur_mod  # noqa: E402
from obvi_slam_tpu_torch.solver import two_phase as tp_mod  # noqa: E402
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
SCALE = dict(n_poses=1024, n_points=16384, n_objects=64, obs_per_point=6, obs_per_object=12,
             seed=0)
# Synthetic phases of the main path and the kernels each must launch.
PHASES = {
    "global": (GLOBAL, ("reproj", "bbox", "band_gram")),
    "window": (WINDOW, ("reproj", "bbox", "syrk")),
    "scale_1024": (SCALE, ("reproj", "bbox", "band_gram")),
}
# The phase that must take the band solve (the others must not).
BAND_SOLVE_PHASE = "scale_1024"
# The runner session: frames, features (enough that the window's point
# gram meets K4's gate, 1024 landmark rows) and the kernels it must launch.
SESSION = dict(n_frames=64, n_features=1200, seed=9)
SESSION_KERNELS = ("reproj", "syrk")
# The gram kernels' operands held against their plain versions: (kernel,
# phase whose compute_step hands them over).
GRAM_CASES = (("band_gram", "global"), ("band_gram", "scale_1024"), ("syrk", "window"))
# The band solve against the dense step: (phase, band-solve gate). Auto at
# 1,024 poses takes cyclic reduction (16 tiles); forced on at 256 poses, the
# sequential tile loop (4 tiles).
BAND_CHECKS = (("scale_1024", "auto"), ("global", "on"))
# The most factor weights in which an f64 run's own outlier selection may
# differ from the f32 kernel run's, as a share of the factors the f32 run
# excluded (H100 readings over two runs of the three phases: 0 to 30
# weights, at most 1.2% of the excluded).
SELECTION_LIMIT = 0.05
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and CUDA-core
# (non-tensor) float32 flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Floating-point operations per live factor of the function (the kernels'
# per-lane and per-factor recomputation of the rotation and conic not counted).
FLOPS_PER_FACTOR = {"reproj": 212, "bbox": 3360}
# Factors per block of K1 and K2, and the shapes of their outputs' rows.
FACTORS_PER_BLOCK = {"reproj": k_reproj.THREADS, "bbox": k_bbox.FACTORS_PER_BLOCK}
OUT_ROWS = {"reproj": ((2,), (2, 6), (2, 3)), "bbox": ((4,), (4, 7), (4, 6))}
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


def ptxas_report(log):
    """[(kernel entry, registers line, spill stores, spill loads)] from an
    nvcc -Xptxas -v log."""
    entries, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:  # ..._cu_<hash><length>name_kernel[_part]I<f|d>E...: name<float|double>
            short = re.search(r"((?:[a-z]+_)+kernel(?:_[a-z]+)?)I([fd])E", m.group(1))
            name = (f"{short.group(1)}<{'float' if short.group(2) == 'f' else 'double'}>"
                    if short else m.group(1)[:60])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        if "Used" in line and "registers" in line and name is not None:
            entries.append((name, line.split(":", 1)[-1].strip(), *spills))
            name, spills = None, (0, 0)
    return entries


def build():
    """Builds every kernel; prints ptxas' registers and spills per kernel
    entry and raises if K1 or K2 spills."""
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for lib, log in sorted(logs.items()):
        for name, regs, stores, loads in ptxas_report(log):
            print(f"  ptxas {lib}: {name}: {regs}; spill stores {stores} B, loads {loads} B")
            if lib in ("reproj", "bbox") and (stores or loads):
                raise AssertionError(f"ptxas: {name} spills ({stores} B stores, {loads} B loads)")


# ---- kernels against their plain versions --------------------------------


def _compare(name, kernel_out, plain_out, dtype, live=None, gram=False):
    """Max abs error over the outputs; raises past the stated tolerance: f64
    rtol 1e-9 with an absolute floor of 1e-11 (for the grams, of 1e-12 of the
    output's largest entry, where long sums cancel), f32 1e-4 of each
    output's largest entry. With ``live``, masked rows must be exactly 0. A
    NaN or Inf fails unless the plain version has the same value there."""
    worst = 0.0
    for k, (a, b) in enumerate(zip(kernel_out, plain_out)):
        if live is not None and not bool((a[~live] == 0).all()):
            raise AssertionError(f"{name} output {k}: masked rows not exactly zero")
        same = (a == b) | (a.isnan() & b.isnan())
        err = torch.where(same, torch.zeros_like(a), (a - b).abs()).nan_to_num(nan=math.inf)
        worst = max(worst, float(err.max()))
        b_abs = b.abs().nan_to_num(nan=0.0, posinf=0.0)  # tolerances from finite entries
        if dtype == torch.float64:
            floor = max(1e-11, 1e-12 * float(b_abs.max())) if gram else 1e-11
            bad = err > floor + 1e-9 * b_abs
            if bool(bad.any()):
                raise AssertionError(
                    f"{name} f64 output {k}: {int(bad.sum())} entries past rtol 1e-9, "
                    f"atol {floor:.1e} (max abs err {float(err.max()):.3e})"
                )
        else:
            limit = 1e-4 * float(b_abs.max())
            if not float(err.max()) <= limit:
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


def _ragged(table, n_extra, block):
    """The table plus ``n_extra`` (or one more) masked rows that copy live
    rows (garbage the kernels must not read into the outputs), at a row count
    that is not a multiple of the kernel's factors per block."""
    if (table.capacity + n_extra) % block == 0:
        n_extra += 1
    rows = torch.arange(n_extra, device=table.mask.device) % table.capacity
    fields = {}
    for name, col in table._asdict().items():
        extra = torch.zeros_like(col[rows]) if name == "mask" else col[rows]
        fields[name] = torch.cat([col, extra]).contiguous()
    return type(table)(**fields)


def _rows(table, n, live=True):
    """Copies of the first ``n`` rows; with ``live`` False, every row masked."""
    fields = {name: col[:n].clone() for name, col in table._asdict().items()}
    if not live:
        fields["mask"] = torch.zeros_like(fields["mask"])
    return type(table)(**fields)


def _cast(nt, dtype):
    """The named tuple with its floating-point tensors in ``dtype``."""
    return type(nt)(*(x.to(dtype) if x.is_floating_point() else x for x in nt))


def _two_cameras(cams, table):
    """``cams`` plus a second camera, rotated 0.05 rad about y and offset by
    a 0.12 m baseline (the stereo session's), with its own intrinsics; and
    ``table`` with every other row on that camera."""
    dt, dev = cams.fx.dtype, cams.fx.device
    a = 0.05
    r = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                      [-math.sin(a), 0.0, math.cos(a)]], dtype=dt, device=dev)
    t = torch.tensor([-0.12, 0.01, 0.02], dtype=dt, device=dev)
    two = type(cams)(
        cam_from_robot_r=torch.cat([cams.cam_from_robot_r, r[None]]),
        cam_from_robot_t=torch.cat([cams.cam_from_robot_t, t[None]]),
        fx=torch.cat([cams.fx, cams.fx[:1] * 1.01]), fy=torch.cat([cams.fy, cams.fy[:1] * 0.99]),
        cx=torch.cat([cams.cx, cams.cx[:1] + 3.0]), cy=torch.cat([cams.cy, cams.cy[:1] - 2.0]),
    )
    cam_idx = (torch.arange(table.capacity, device=dev) % 2).to(table.cam_idx.dtype)
    return two, table._replace(cam_idx=cam_idx)


def _factor_fns(name):
    if name == "reproj":
        return ops.reproj_residuals_and_jac, fac.reproj_residuals_and_jac_fast
    return ops.bbox_residuals_and_jac, fac.bbox_residuals_and_jac


def _factor_case(name, state, cams, table, dtype, label):
    """K1 or K2 against its plain version on one table; masked rows exactly
    0. At n = 0 only the output shapes (the plain K2's vmap refuses an empty
    batch). Returns the max abs error."""
    wrapper, plain = _factor_fns(name)
    out_k = wrapper(state, cams, table)
    torch.cuda.synchronize()
    n = table.capacity
    if n == 0:
        shapes = [tuple(x.shape) for x in out_k]
        if shapes != [(0,) + rows for rows in OUT_ROWS[name]]:
            raise AssertionError(f"{name} {label}: output shapes {shapes}")
        return 0.0
    return _compare(f"{name} {label}", out_k, plain(state, cams, table), dtype, table.mask)


def _check_saturated(state, cams, bbox, dtype):
    """K2 with object 0 around pose 0's camera: its live rows must give
    invalid_error and exactly zero Jacobians, as the plain version."""
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
    return _compare("bbox saturated", out_k, out_p, dtype, bbox.mask), int(invalid.sum())


def check_depth_zero():
    """K1 in f64 at a camera depth of exactly 0: a zero pose, an identity
    camera and the point at the camera centre. The plain version maps
    |z| < 1e-300 to 1e-300, so its outputs are finite; the kernel must agree."""
    dt = torch.float64
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=DEVICE)  # noqa: E731
    state = ot.types.BAState(poses=zeros(1, 6), points=zeros(1, 3), objects=zeros(1, 7))
    cams = ot.types.make_camera_bundle(
        np.eye(3)[None], np.zeros((1, 3)), [500.0], [500.0], [320.0], [240.0], np.float64,
        DEVICE,
    )
    idx = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    f = ot.types.ReprojectionFactors(
        pose_idx=idx, point_idx=idx.clone(), cam_idx=idx.clone(),
        rect_obs=torch.tensor([[0.25, -0.5]], dtype=dt, device=DEVICE),
        multiplier=torch.tensor([[2.0, 3.0]], dtype=dt, device=DEVICE),
        mask=torch.ones(1, dtype=torch.bool, device=DEVICE),
    )
    out_k = ops.reproj_residuals_and_jac(state, cams, f)
    out_p = fac.reproj_residuals_and_jac_fast(state, cams, f)
    torch.cuda.synchronize()
    for what, out in (("kernel", out_k), ("plain", out_p)):
        if not all(bool(torch.isfinite(x).all()) for x in out):
            raise AssertionError(f"reproj depth 0: non-finite {what} outputs {out}")
    err = _compare("reproj depth 0", out_k, out_p, dt)
    print(f"reproj depth 0 (f64): r {out_k[0].tolist()}, J_point[0, 0, 0] "
          f"{float(out_k[2][0, 0, 0]):.6e}, max abs err {err:.3e} - ok")


def check_kernels(np_dtype):
    """K1 and K2 against their plain versions at both phases' tables (the
    window's 64 poses and the global problem's 256): each table padded with
    masked garbage rows to a count that is not a multiple of a block's
    factors, its first row (n = 1), no rows (n = 0), every row masked and
    the padded table with every other row on a second camera with a non-zero
    extrinsic translation; K2 also with a camera inside an ellipsoid
    (saturated rows); two launches equal bit for bit; in f64 also K1 at depth
    0. Returns the max abs error per kernel."""
    errs = {"reproj": 0.0, "bbox": 0.0}
    for label, (size, _) in PHASES.items():
        state, _, cams, tables, *_ = problem(np_dtype, size)
        dtype = state.poses.dtype
        notes = []
        for name, table, n_extra in (("reproj", tables.reproj, 300), ("bbox", tables.bbox, 30)):
            padded = _ragged(table, n_extra, FACTORS_PER_BLOCK[name])
            cases = {
                f"padded to {padded.capacity}": (cams, padded),
                "n=1": (cams, _rows(table, 1)),
                "n=0": (cams, _rows(table, 0)),
                "all masked": (cams, _rows(padded, padded.capacity, live=False)),
                "two cameras": _two_cameras(cams, padded),
            }
            for case, (c, t) in cases.items():
                errs[name] = max(errs[name], _factor_case(name, state, c, t, dtype,
                                                          f"{label} {case}"))
            wrapper = _factor_fns(name)[0]
            first, second = wrapper(state, cams, padded), wrapper(state, cams, padded)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"{name} kernel: two launches on the same tables differ")
            notes.append(f"{name} {padded.capacity} rows ({int(padded.mask.sum())} live, "
                         f"{padded.capacity % FACTORS_PER_BLOCK[name]} in the last block)")
        err_sat, n_sat = _check_saturated(
            state, cams, _ragged(tables.bbox, 30, FACTORS_PER_BLOCK["bbox"]), dtype)
        errs["bbox"] = max(errs["bbox"], err_sat)
        print(
            f"kernels vs plain {str(dtype).split('.')[-1]} at the {label} tables "
            f"({state.poses.shape[0]} poses; {', '.join(notes)}; n=1, n=0, all masked, "
            f"two cameras (0.12 m baseline); "
            f"{n_sat} saturated bbox rows; two launches bit for bit): reproj max abs err "
            f"{errs['reproj']:.3e}, bbox {errs['bbox']:.3e} - ok"
        )
    if np_dtype == np.float64:
        check_depth_zero()
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


def _gram_fns(name):
    """(ops wrapper name, launch, plain version) of a gram kernel."""
    if name == "band_gram":
        return "band_zbuild_gram", band_gram.launch, band_gram.band_zbuild_gram_plain
    return "syrk_gram", syrk.launch, syrk.syrk_gram_plain


def check_grams(np_dtype):
    """K3 at the global and scale_1024 problems' operands and K4 at the
    window's against their plain versions; the grams must come out exactly
    symmetric, K3's z rows of dead slots exactly 0, and two launches equal
    bit for bit. Returns (errors per kernel, operands per GRAM_CASES entry)."""
    errs, operands = {}, {}
    for name, label in GRAM_CASES:
        wrapper, launch, plain = _gram_fns(name)
        args = captured_operands(PHASES[label][0], np_dtype, wrapper)
        dtype = args[0].dtype
        out = launch(*args)
        out = out if isinstance(out, tuple) else (out,)
        out_p = plain(*args)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        torch.cuda.synchronize()
        gram = out[-1]
        if not bool((gram == gram.transpose(-1, -2)).all()):
            raise AssertionError(f"{name} ({label}): output not exactly symmetric")
        note = ""
        if name == "band_gram":
            dead = (args[1] >= band_gram.WIDTH).all(-1)
            if not bool((out[0][dead] == 0).all()):
                raise AssertionError(f"band_gram ({label}): z rows of dead slots not exactly zero")
            splits = band_gram.plan(*args[0].shape[:2]).splits
            note = f", G = {args[0].shape[0]}, {int(dead.sum())} dead rows, {splits} splits"
        err = _compare(f"{name} ({label})", out, out_p, dtype, gram=True)
        errs[name] = max(errs.get(name, 0.0), err)
        again = launch(*args)
        again = again if isinstance(again, tuple) else (again,)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(out, again)):
            raise AssertionError(f"{name} ({label}): two launches on the same operands differ")
        print(
            f"gram vs plain {str(dtype).split('.')[-1]}: {name} at the {label} operands "
            f"({tuple(args[0].shape)}{note}) max abs err {err:.3e} (largest |s| "
            f"{float(out_p[-1].abs().max()):.3e}); two launches bit for bit - ok"
        )
        operands[(name, label)] = args
    check_gram_edges(dtype, operands[("syrk", "window")][0])
    return errs, operands


def band_edge_operands(n_group, k_rows, n_slot, dtype, seed=0):
    """K3 operands off the main path: local poses drawn from all of [0, 128),
    distinct per row except rows 3, 4, 5, 6 (mod 8): a repeated pose (summed),
    dead slots (128), an all-dead row, dead slots outside [0, 128) (-1, 200)."""
    rng = np.random.default_rng(seed)
    w_rows = rng.normal(size=(n_group, k_rows, 6 * n_slot)) * rng.lognormal(
        0, 1, (n_group, k_rows, 6 * n_slot)
    )
    local = np.stack([
        np.stack([rng.choice(128, n_slot, replace=False) for _ in range(k_rows)])
        for _ in range(n_group)
    ])
    rows = np.arange(k_rows) % 8
    local[:, rows == 3, 1] = local[:, rows == 3, 0]
    local[:, rows == 4, 2:] = 128
    local[:, rows == 5, :] = 128
    local[:, rows == 6, 0] = -1
    local[:, rows == 6, -1] = 200
    return (torch.tensor(w_rows, dtype=dtype, device=DEVICE),
            torch.tensor(local, dtype=torch.int32, device=DEVICE))


def dense_operand(k_rows, m, dtype, gen, offset=0):
    """A (k_rows, m) C with no zeros, as a contiguous view that starts
    ``offset`` elements into its buffer (so off 16 bytes for offset 1)."""
    flat = torch.randn(offset + k_rows * m, generator=gen, dtype=torch.float64)
    flat.add_(torch.where(torch.rand(flat.shape, generator=gen) < 0.5, 3.0, -3.0))
    return flat.to(dtype=dtype, device=DEVICE)[offset:].view(k_rows, m)


def check_gram_edges(dtype, c_window):
    """K3 and K4 against their plain versions on operands the main path does
    not give them: K4 on dense ragged C with no zeros (M a multiple of the
    16-byte vector, M odd, and a view off 16 bytes: the last two take the
    4- or 8-byte access path), on the window's operand with its rows
    permuted, and at K = 0 and M = 0; K3 on band_edge_operands (K = 1000,
    not a multiple of a chunk), at K = 0 and G = 0. Outputs must come out
    exactly symmetric and dead rows of z exactly 0."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    name = str(dtype).split(".")[-1]
    syrk_cases = {
        "dense 1031x200": dense_operand(1031, 200, dtype, gen),
        "dense 1031x201": dense_operand(1031, 201, dtype, gen),
        "dense 1031x200 off 16 B": dense_operand(1031, 200, dtype, gen, offset=1),
        "window rows permuted": c_window[torch.randperm(c_window.shape[0], generator=gen)
                                         .to(DEVICE)].contiguous(),
        "K=0": torch.zeros((0, 70), dtype=dtype, device=DEVICE),
        "M=0": torch.zeros((5, 0), dtype=dtype, device=DEVICE),
    }
    for label, c in syrk_cases.items():
        if label.startswith("dense") and not bool((c != 0).all()):
            raise AssertionError("dense syrk operand holds a zero")
        if label.endswith("off 16 B") and c.data_ptr() % 16 == 0:
            raise AssertionError("syrk operand meant to lie off 16 bytes is aligned")
        s4 = syrk.launch(c)
        plain = syrk.syrk_gram_plain(c)
        torch.cuda.synchronize()
        if not bool((s4 == s4.T).all()):
            raise AssertionError(f"syrk {label}: output not exactly symmetric")
        err = _compare(f"syrk {label}", (s4,), (plain,), dtype, gram=True) if s4.numel() else 0.0
        print(f"syrk edge {name} {label} (c {tuple(c.shape)}): max abs err {err:.3e} - ok")
    band_cases = {
        "edge G=3 K=1000 C=6": band_edge_operands(3, 1000, 6, dtype),
        "K=0": (torch.zeros((2, 0, 36), dtype=dtype, device=DEVICE),
                torch.zeros((2, 0, 6), dtype=torch.int32, device=DEVICE)),
        "G=0": (torch.zeros((0, 8, 36), dtype=dtype, device=DEVICE),
                torch.zeros((0, 8, 6), dtype=torch.int32, device=DEVICE)),
    }
    for label, (w_rows, local_pose) in band_cases.items():
        z, s = band_gram.launch(w_rows, local_pose)
        plain = band_gram.band_zbuild_gram_plain(w_rows, local_pose)
        torch.cuda.synchronize()
        dead = ((local_pose < 0) | (local_pose >= band_gram.WIDTH)).all(-1)
        if not bool((z[dead] == 0).all()):
            raise AssertionError(f"band_gram {label}: z rows of dead slots not exactly zero")
        if not bool((s == s.transpose(1, 2)).all()):
            raise AssertionError(f"band_gram {label}: output not exactly symmetric")
        pairs = [(a, b) for a, b in zip((z, s), plain) if a.numel()]
        err = _compare(f"band_gram {label}", *zip(*pairs), dtype, gram=True) if pairs else 0.0
        print(f"band_gram edge {name} {label}: {int(dead.sum())} dead rows, "
              f"max abs err {err:.3e} - ok")


def syrk_tile_rows(c):
    """Rows of C that each lower 64 x 64 tile pair of K4 multiplies (a
    non-zero in both of its 64-column panels), as a (pairs,) tensor."""
    k_rows, m = c.shape
    p = syrk.plan(k_rows, m)
    pad = torch.nn.functional.pad(c != 0, (0, p.tiles * syrk.TILE - m))
    panel = pad.reshape(k_rows, p.tiles, syrk.TILE).any(-1)  # (K, tiles)
    ti, tj = zip(*(lower_pair(t) for t in range(p.pairs)))
    return (panel[:, list(ti)] & panel[:, list(tj)]).sum(0)


def band_tile_rows(local_pose):
    """z rows that each (group, lower 16-pose panel pair) of K3 multiplies
    (a live slot in both panels), as a (G, PAIRS) tensor."""
    lp = local_pose.long()
    live = (lp >= 0) & (lp < band_gram.WIDTH)
    panel = torch.where(live, lp // band_gram.PANEL, band_gram.PANELS)
    hit = torch.zeros(lp.shape[:2] + (band_gram.PANELS + 1,), dtype=torch.bool, device=lp.device)
    hit.scatter_(-1, panel, True)
    pi, pj = zip(*(lower_pair(t) for t in range(band_gram.PAIRS)))
    return (hit[..., list(pi)] & hit[..., list(pj)]).sum(1)


def gram_tiles(gram_ops):
    """Prints, per gram kernel at each of its main-path operands, the blocks
    of each device kernel as its launcher reported them for one call, and the
    rows each output tile multiplies, counted on the host from the operands.
    Runs outside any timed call."""
    for (name, label), args in gram_ops.items():
        if name == "band_gram":
            w_rows, local_pose = args
            band_gram.launch(w_rows, local_pose)
            mod, p, rows = band_gram, band_gram.plan(*w_rows.shape[:2]), band_tile_rows(local_pose)
        else:
            (c,) = args
            syrk.launch(c)
            mod, p, rows = syrk, syrk.plan(*c.shape), syrk_tile_rows(c)
        torch.cuda.synchronize()
        rows = rows.flatten().double()
        print(f"{name} ({label}) blocks launched {dict(mod.last_blocks)} ({p.splits} splits "
              f"of {p.split_rows} rows); rows per tile over {rows.numel()} tiles: mean "
              f"{float(rows.mean()):.2f}, max {int(rows.max())}, "
              f"{int((rows == 0).sum())} empty")


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


def check_band_vs_dense(label, gate):
    """One f64 plain step through the band solve against the f64 plain dense
    step (band solve gate off: the (6P)^2 S and its Cholesky), relative 1e-8
    (tests/test_band_solve.py:271). At scale_1024 (16 tiles) the auto gate
    takes the band solve with cyclic reduction; at global (4 tiles) the gate
    is forced on, as a caller may below 512 poses, and the tiles are factored
    by the sequential loop."""
    state, _, cams, tables, plan, free, weights, huber = problem(np.float64, PHASES[label][0])
    schur_mod._BAND_SOLVE = gate
    try:
        with (BandSolveSpy() as spy, Spy(band_solve, "cr_factor") as cr,
              Spy(band_solve, "block_tridiag_cholesky") as seq):
            band = ot.compute_step(state, cams, tables, plan, free, weights, 1e4, huber, plain=True)
        schur_mod._BAND_SOLVE = "off"
        dense = ot.compute_step(state, cams, tables, plan, free, weights, 1e4, huber, plain=True)
    finally:
        schur_mod._BAND_SOLVE = "auto"
    torch.cuda.synchronize()
    nb = state.poses.shape[0] // schur_mod.BAND_TP
    path = "cyclic reduction" if band_solve._use_cyclic_reduction(nb) else "sequential"
    if (spy.calls, cr.calls + seq.calls) != (1, 1) or (cr.calls == 1) != (path == "cyclic reduction"):
        raise AssertionError(f"{label} f64 step: {spy.calls} band solves, {cr.calls} cyclic "
                             f"reduction and {seq.calls} sequential factorizations; expected one "
                             f"{path}")
    errs = {name: rel(getattr(band[0], name), getattr(dense[0], name))
            for name in ("poses", "points", "objects")}
    errs["model_cost_change"] = abs(float(band[1]) - float(dense[1])) / abs(float(dense[1]))
    print(f"{label} step f64 plain, band solve ({nb} tiles, {path}, gate {gate}) vs dense "
          "Cholesky: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        if not v <= 1e-8:
            raise AssertionError(f"{label} band vs dense step {k} relative error {v:.3e} > 1e-8")


class Spy:
    """Counts the calls of ``module.name`` while active, and keeps the
    arguments and the result of the last one."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        self.calls, self.operands, self.result = 0, None, None
        self.inner = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls += 1
            self.operands = args
            self.result = self.inner(*args, **kw)
            return self.result

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def BandSolveSpy():
    return Spy(band_solve, "woodbury_band_solve")


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


def reference_two_phase(problem, weights2):
    """The two phases of solve_two_phase through the plain versions, phase 2
    with the given weights."""
    state, _, cams, tables, plan, free, weights, huber = problem
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, r1 = solve(state, cams, tables, plan, free, weights, LMParams(), huber, plain=True)
    final, r2 = solve(state, cams, tables, plan, free, weights2, LMParams(), huber, plain=True)
    torch.cuda.synchronize()
    return final, r1, r2, time.perf_counter() - t0


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

    torch.cuda.reset_peak_memory_stats()
    with BandSolveSpy() as spy, Spy(tp_mod, "reweight_on_device") as selection:
        ops.reset_kernel_launches()
        final, s1, s2, wall = run_two_phase(problem32, plain=False)
        launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()

    check_result(final, (s1, s2), f"{label} f32 kernels")
    iters = s1.num_iterations + s2.num_iterations
    print(f"{label}: {iters} LM iterations in {wall:.4f} s wall, "
          f"{iters / wall:.2f} LM iterations/s; peak device memory {peak} B")
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the {label} phase")
    if (spy.calls > 0) != (label == BAND_SOLVE_PHASE):
        raise AssertionError(f"{label}: {spy.calls} band solves")
    print(f"{label} launches: {launches}; band solves {spy.calls} "
          f"({spy.calls / iters:.2f} per LM iteration)")

    # The reference: both phases in f64 through the plain versions, phase 2
    # with the f32 run's factor selection. Two runs that select their own
    # outliers at slightly different phase-1 optima can exclude different
    # factors at the 10% boundary, and then solve different phase-2 problems.
    weights2 = schur_mod.FactorWeights(*(w.double() for w in selection.result))
    excluded = int(((problem32[3].reproj.mask) & (weights2.reproj == 0)).sum())
    final64, r1, r2, wall64 = reference_two_phase(problem(np.float64, size), weights2)
    check_result(final64, (r1, r2), f"{label} f64 plain")
    print(f"{label} f64 plain: {wall64:.4f} s wall; phase 2 with the f32 run's selection "
          f"({excluded} reprojection factors excluded)")
    for k, (a, b) in enumerate(((s1, r1), (s2, r2)), 1):
        gap = abs(a.final_cost - b.final_cost) / b.final_cost
        print(f"{label} phase {k} final cost f32 kernels vs f64 plain: relative gap {gap:.3e}")
        if not gap <= 1e-3:
            raise AssertionError(f"{label} phase {k} final cost gap {gap:.3e} > 1e-3")
    # The independent reference: an f64 plain solve_two_phase that selects
    # its own outliers. Its selection may differ from the f32 run's in at
    # most SELECTION_LIMIT of the factors the f32 run excluded; where the two
    # agree, its phase-2 final cost must lie within 1e-3 as well.
    with Spy(tp_mod, "reweight_on_device") as own:
        _, _, own2, _ = run_two_phase(problem(np.float64, size), plain=True)
    changed = sum(int((a != b).sum()) for a, b in zip(own.result, weights2))
    own_gap = abs(s2.final_cost - own2.final_cost) / own2.final_cost
    print(f"{label} f64 plain with its own selection: {changed} factor weights differ from "
          f"the f32 run's (limit {SELECTION_LIMIT * excluded:.1f}); phase 2 final cost gap "
          f"{own_gap:.3e}")
    if not changed <= SELECTION_LIMIT * excluded:
        raise AssertionError(f"{label}: {changed} factor weights of the f64 run's own selection "
                             f"differ from the f32 run's, more than {SELECTION_LIMIT} of "
                             f"{excluded} excluded")
    if changed == 0 and not own_gap <= 1e-3:
        raise AssertionError(f"{label}: same selection, phase 2 final cost gap {own_gap:.3e} "
                             "> 1e-3")
    return dict(launches=launches, iters=iters, wall=wall, band_solves=spy.calls,
                band_operands=spy.operands)


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


# ---- the runner session ----------------------------------------------------


def _ate(poses, gt):
    """Translation RMSE of (frame -> pose) against the ground truth."""
    return float(np.sqrt(np.mean([np.sum((poses[i][:3] - gt[i, :3]) ** 2)
                                  for i in range(len(gt))])))


def run_session(dtype, plain, profile_frames=None):
    """One OfflineProblemRunner session at the reference's default config,
    with ``profile_frames`` (a range of online frames) under torch.profiler.
    Returns a dict: runner, pg, gt, odometry ATE, seconds per online frame
    (data adding + optimization, frames 1..N-1), seconds of the final
    optimization and of the online portion, and (profile, wall s of the
    profiled frames) or None."""
    from torch.profiler import ProfilerActivity, profile

    data, gt, _ = ot.synthetic_session(**SESSION)
    runner = ot.OfflineProblemRunner(
        ot.config.FullOVSLAMConfig(), dtype=dtype, device=DEVICE, plain=plain
    )
    pg = ot.PoseGraph(data.cameras)
    frame_s, prof, prof_t = {}, None, []
    add, iterate = runner.add_frame_data, runner.run_optimization_iteration

    def timed_add(data_, pg_, lo, frame):
        nonlocal prof
        if profile_frames and frame == profile_frames[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA]).__enter__()
            prof_t.append(time.perf_counter())
        t0 = time.perf_counter()
        add(data_, pg_, lo, frame)
        frame_s[frame] = frame_s.get(frame, 0.0) + time.perf_counter() - t0

    def timed_iterate(data_, pg_, lo, frame, max_frame, attempt_num=0):
        t0 = time.perf_counter()
        out = iterate(data_, pg_, lo, frame, max_frame, attempt_num)
        key = frame if attempt_num == 0 else "final"
        frame_s[key] = frame_s.get(key, 0.0) + time.perf_counter() - t0
        if profile_frames and key == profile_frames[-1]:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof_t.append(time.perf_counter())
        return out

    runner.add_frame_data, runner.run_optimization_iteration = timed_add, timed_iterate
    TimerRegistry.instance().reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not runner.run_optimization(data, pg, visual_frontend=visual_frontend_for(runner, data)):
        raise AssertionError("session: run_optimization returned False")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return dict(
        runner=runner, pg=pg, gt=gt, odom_ate=_ate(data.initial_poses, gt),
        online=[frame_s[f] for f in range(1, SESSION["n_frames"])],
        final_s=frame_s["final"], online_s=total - frame_s["final"],
        profile=None if prof is None else (prof, prof_t[1] - prof_t[0]),
    )


def session_phase():
    """The session in f32 through the kernels, between a reset and a read of
    the launch counts, with K1's and K4's operands captured; its trajectory error
    against the odometry's (tests/test_runner_e2e.py:168-173); then the same
    session in f64 through the plain versions, whose error must lie within
    10% of the f32 run's."""
    # K4's operand shapes, and its first operand at the largest landmark
    # count (a window's first LM iteration, before damping has grown: the
    # last operand of a solve that ends at the minimum trust region is
    # scaled towards 0).
    shapes, kept = set(), []
    inner = ops.syrk_gram

    def spy(c):
        shapes.add(tuple(c.shape))
        if not kept or c.shape[0] > kept[0].shape[0]:
            kept[:] = [c]
        return inner(c)

    # K1's operands at the largest reprojection table (a copy: the state
    # moves on).
    reproj_kept = []
    reproj_inner = ops.reproj_residuals_and_jac

    def reproj_spy(state, cams, f):
        if not reproj_kept or f.capacity > reproj_kept[0][2].capacity:
            reproj_kept[:] = [tuple(type(x)(*(t.clone() for t in x)) for x in (state, cams, f))]
        return reproj_inner(state, cams, f)

    ops.syrk_gram, ops.reproj_residuals_and_jac = spy, reproj_spy
    torch.cuda.reset_peak_memory_stats()
    try:
        with BandSolveSpy() as band:
            ops.reset_kernel_launches()
            run = run_session(np.float32, False)
            launches = ops.kernel_launches()
    finally:
        ops.syrk_gram, ops.reproj_residuals_and_jac = inner, reproj_inner
    peak = torch.cuda.max_memory_allocated()
    timers = TimerRegistry.instance().summary()
    runner, pg, online, online_s = run["runner"], run["pg"], run["online"], run["online_s"]
    n_frames = SESSION["n_frames"]
    ate = _ate([pg.get_robot_pose(i) for i in range(n_frames)], run["gt"])
    odom = run["odom_ate"]
    log = runner.opt_log
    iters = sum(r.iterations for r in log)
    solve_s = sum(t["total_s"] for name, t in timers.items() if name.endswith("_solve_opt"))
    for r in log:
        if r.termination not in TERMINATION_NAMES.values():
            raise AssertionError(f"session frame {r.frame_id}: termination {r.termination}")
    print(
        f"session ({n_frames} frames, {SESSION['n_features']} features generated, "
        f"{len(pg.features)} admitted; window "
        f"{runner.config.sliding_window_params.local_ba_window_size}, global BA every "
        f"{runner.config.sliding_window_params.global_ba_frequency}): {len(log)} solves, "
        f"{iters} LM iterations; ATE {ate:.6f} m (odometry {odom:.6f} m); band solves "
        f"{band.calls}; peak device memory {peak} B"
    )
    print(
        f"session f32 kernels: online portion {online_s:.4f} s, {len(online) / online_s:.3f} "
        f"frames/s; ms per frame median {statistics.median(online) * 1e3:.2f}, p90 "
        f"{float(np.percentile(online, 90)) * 1e3:.2f}, max {max(online) * 1e3:.2f}; final "
        f"optimization {run['final_s']:.4f} s; {iters / solve_s:.2f} LM iterations/s over "
        f"{solve_s:.4f} s of solves"
    )
    for name, t in sorted(timers.items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"  timer {name}: {t['total_s']:.4f} s in {t['invocations']} calls")
    for name in SESSION_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the session phase")
    print(f"session launches: {launches}; K4 operand shapes {sorted(shapes)}")
    if not (ate < 0.5 * odom and ate < 0.05):
        raise AssertionError(f"session ATE {ate:.6f} m: not below half the odometry's "
                             f"({odom:.6f} m) and 0.05 m")

    run64 = run_session(np.float64, True)
    ate64 = _ate([run64["pg"].get_robot_pose(i) for i in range(n_frames)], run64["gt"])
    print(f"session f64 plain: ATE {ate64:.6f} m, {len(run64['runner'].opt_log)} solves, "
          f"{sum(r.iterations for r in run64['runner'].opt_log)} LM iterations, online "
          f"portion {run64['online_s']:.4f} s, final {run64['final_s']:.4f} s")
    if not abs(ate64 - ate) <= 0.1 * ate:
        raise AssertionError(f"session ATE f32 {ate:.6f} vs f64 plain {ate64:.6f}: past 10%")
    return dict(launches=launches, iters=iters, wall=online_s + run["final_s"],
                syrk_operand=kept[0], reproj_operands=reproj_kept[0],
                frames_per_s=len(online) / online_s)


def profile_session(n_frames=8):
    """The f32 session once more, its last ``n_frames`` online frames under
    torch.profiler: device busy time, kernels and busy share per frame. Runs
    after the kernel timings: a profile of this many device ops can leave
    later profiler windows short of kernel records."""
    last = SESSION["n_frames"]
    frames = range(last - n_frames, last)
    prof, wall = run_session(np.float32, False, profile_frames=frames)["profile"]
    profile_summary(f"session frames {frames[0]}-{frames[-1]}", prof, wall, n_frames, "frame")


def profile_summary(label, prof, wall_s, n, unit, top=8):
    """Device busy ms, device kernels and busy share per ``unit`` over ``n``
    of them from a torch.profiler run of ``wall_s`` seconds; the top device
    ops. Returns busy ms (0.0 when the profiler saw no device time)."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    if busy_ms <= 0:
        print(f"profile {label}: the profiler saw no device time; busy share not measured")
        return 0.0
    print(
        f"profile {label}: device busy {busy_ms:.2f} ms over {n} {unit}s, "
        f"{busy_ms / n:.3f} ms per {unit}; {n_kernels} device kernels ({n_kernels / n:.0f} "
        f"per {unit}); busy share {busy_ms / (wall_s * 1e3):.4f} of the profiled wall "
        f"{wall_s:.4f} s"
    )
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return busy_ms


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


def device_kernels_per_call(fn, calls=10):
    """Device operations (kernels, copies, fills) per call of ``fn``, counted
    by torch.profiler over ``calls`` calls; 0.0 when it sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(
        e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ) / calls


def launch_floor():
    """The smallest kernel the card runs, a one-element ``torch.add``: device
    ms per call (profiler) and back-to-back CUDA-event ms."""
    x = torch.ones(1, device=DEVICE)
    return device_ms(lambda: torch.add(x, x)), time_ms(lambda: torch.add(x, x))


def _kernel_cases(state, cams, tables, band_ops, c):
    """{name: (kernel, wrapper, plain, library, inputs, flops, dense flops)}
    for K1 and K2 on ``tables``, K3 on ``band_ops`` and K4 on ``c``."""
    cam_r, cam_t = cams.cam_from_robot_r, cams.cam_from_robot_t
    rp, bb = tables.reproj, tables.bbox
    w_rows, local_pose = band_ops
    z, _ = band_gram.launch(w_rows, local_pose)
    m_k4 = c.shape[1]
    return {
        "reproj": (
            lambda: k_reproj.launch(state.poses, state.points, cam_r, cam_t, rp),
            lambda: ops.reproj_residuals_and_jac(state, cams, rp),
            lambda: fac.reproj_residuals_and_jac_fast(state, cams, rp),
            None,
            (state.poses, state.points, cam_r, cam_t, rp.pose_idx, rp.point_idx,
             rp.cam_idx, rp.rect_obs, rp.multiplier, rp.mask),
            FLOPS_PER_FACTOR["reproj"] * int(rp.mask.sum()), None,
        ),
        "bbox": (
            lambda: k_bbox.launch(state.objects, state.poses, cam_r, cam_t, bb),
            lambda: ops.bbox_residuals_and_jac(state, cams, bb),
            lambda: fac.bbox_residuals_and_jac(state, cams, bb),
            None,
            (state.objects, state.poses, cam_r, cam_t, bb.obj_idx, bb.pose_idx, bb.cam_idx,
             bb.rect_corners, bb.sqrt_inf, bb.mask),
            FLOPS_PER_FACTOR["bbox"] * int(bb.mask.sum()), None,
        ),
        "band_gram": (
            lambda: band_gram.launch(w_rows, local_pose),
            lambda: ops.band_zbuild_gram(w_rows, local_pose),
            lambda: band_gram.band_zbuild_gram_plain(w_rows, local_pose),
            lambda: torch.bmm(z.transpose(1, 2), z),
            (w_rows, local_pose),
            _gram_flops(z), z.shape[0] * z.shape[1] * band_gram.WBAND * (band_gram.WBAND + 1),
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


def _measure(name, kernel, wrapper, plain, library, inputs, flops):
    """Device ms of one call of the kernel (K1/K2: all device work of the
    wrapper call, which must be one kernel), of the plain version and of the
    library call; back-to-back CUDA-event ms of each; the bound from the
    inputs' and outputs' bytes and the flops."""
    factor_kernel = name in FACTORS_PER_BLOCK
    per_call = None
    if factor_kernel:
        per_call = device_kernels_per_call(wrapper)
        if per_call != 1:
            # One more count over more calls before failing: a profiler
            # window on a busy host can lose kernel records.
            first, per_call = per_call, device_kernels_per_call(wrapper, calls=20)
            print(f"{name} wrapper: {first:g} device operations per call counted; "
                  f"recounted over 20 calls: {per_call:g}")
        if per_call != 1:
            raise AssertionError(
                f"{name} wrapper: {per_call} device operations per call, expected 1")
    out = kernel()
    out = out if isinstance(out, tuple) else (out,)
    bytes_moved = _nbytes(*inputs) + _nbytes(*out)
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / F32_FLOPS_PER_S * 1e3
    m = dict(
        event_ms=time_ms(kernel), wrapper_event_ms=time_ms(wrapper),
        plain_event_ms=time_ms(plain, inner=5, reps=5),
        ms=device_ms(wrapper) if factor_kernel else device_ms(kernel, match=f"{name}_kernel"),
        plain_ms=device_ms(plain, calls=5),
        library_ms=None if library is None else device_ms(library, calls=5),
        source="profiler device time",
    )
    if m["ms"] <= 0 or m["plain_ms"] <= 0:
        m.update(ms=m["event_ms"], plain_ms=m["plain_event_ms"],
                 source="CUDA events (profiler saw no device time)",
                 library_ms=None if library is None else time_ms(library, inner=5, reps=5))
    m.update(bound_ms=max(byte_ms, flop_ms),
             bound_by="bytes" if byte_ms >= flop_ms else "operations",
             bytes=bytes_moved, flops=flops, device_kernels_per_call=per_call)
    return m


def time_kernels(errs, phases, gram_ops, session):
    """Each kernel alone, its wrapper and its plain version in f32, at the
    main path's shapes: K1 and K2 on the window's tables, K3 on the global
    problem's operands, K4 on the window's point gram (the JSON line's
    numbers); and at the larger phases' shapes: K1, K2 and K3 at scale_1024,
    K4 at the session's last point gram (under ``at``). Device times come
    from the profiler; CUDA-event times of back-to-back calls are also
    printed: they measure the host's issue rate when it is the slower side.
    K1's and K2's bounds count the function's inputs (raw poses, points or
    objects, camera arrays, factor columns) and outputs, each byte once; the
    bound on the earlier design's inputs, a per-pose (P, 21) [t | R^T | Jr]
    and a per-camera (C, 12) table built by the wrapper, is printed beside.
    The grams' bounds count the products of the rows' non-zeros (this run's
    data); the dense count is printed beside."""
    state, _, cams, tables, *_ = problem(np.float32)
    base = _kernel_cases(state, cams, tables, gram_ops[("band_gram", "global")],
                         gram_ops[("syrk", "window")][0])
    big_state, _, big_cams, big_tables, *_ = problem(np.float32, SCALE)
    larger = _kernel_cases(big_state, big_cams, big_tables,
                           gram_ops[("band_gram", "scale_1024")], session["syrk_operand"])
    larger_label = {"reproj": "scale_1024", "bbox": "scale_1024", "band_gram": "scale_1024",
                    "syrk": "session"}
    floor_ms, floor_event_ms = launch_floor()
    print(f"launch floor (one-element torch.add): {floor_ms:.5f} ms device time, "
          f"{floor_event_ms:.4f} ms back-to-back CUDA events")
    # Bytes of those (P, 21) and (C, 12) tables, in place of poses and camera arrays.
    cam_t = cams.cam_from_robot_t
    old_tables = (state.poses.shape[0] * 21 + cam_t.shape[0] * 12) * state.poses.element_size()
    all_phases = dict(phases, session=session)
    rows = []
    for name, case in base.items():
        m = _measure(name, *case[:6])
        dense_flops = case[6]
        by_phase = {label: ph["launches"][name] for label, ph in all_phases.items()}
        per_iter = {label: ph["launches"][name] / ph["iters"]
                    for label, ph in all_phases.items() if ph["launches"][name]}
        launches = sum(by_phase.values())
        iters = sum(ph["iters"] for ph in all_phases.values() if ph["launches"][name])
        extra = ""
        if dense_flops is not None:
            extra = (f"; dense gram {dense_flops} flop, "
                     f"{dense_flops / F32_FLOPS_PER_S * 1e6:.3f} us at 67 TFLOP/s")
        if name in FACTORS_PER_BLOCK:
            old_bytes = m["bytes"] - _nbytes(state.poses, cams.cam_from_robot_r, cam_t) + old_tables
            extra = (f"; on (P, 21)/(C, 12) pose/camera tables {old_bytes} B, "
                     f"{max(old_bytes / HBM_BYTES_PER_S, m['flops'] / F32_FLOPS_PER_S) * 1e6:.4f}"
                     f" us; {m['device_kernels_per_call']:g} device kernel per wrapper call; "
                     f"launch floor {floor_ms:.5f} ms")
        library_txt = "none" if m["library_ms"] is None else f"{m['library_ms']:.5f} ms"
        print(
            f"kernel {name}: {m['ms']:.5f} ms per launch, plain version {m['plain_ms']:.5f} ms "
            f"per call, library {library_txt} ({m['source']}); back-to-back CUDA events: kernel "
            f"{m['event_ms']:.4f} ms, wrapper {m['wrapper_event_ms']:.4f} ms, plain "
            f"{m['plain_event_ms']:.4f} ms; bound {m['bound_ms'] * 1e3:.4f} us "
            f"({m['bytes']} B at 3.35 TB/s, {m['flops']} flop{extra}); launches {by_phase}, "
            f"{launches / iters:.2f} per LM iteration"
        )
        label = larger_label[name]
        big = _measure(name, *larger[name][:6])
        library_txt = "none" if big["library_ms"] is None else f"{big['library_ms']:.5f} ms"
        print(
            f"kernel {name} at the {label} shapes: {big['ms']:.5f} ms per launch, plain "
            f"{big['plain_ms']:.5f} ms, library {library_txt} ({big['source']}); bound "
            f"{big['bound_ms'] * 1e3:.4f} us ({big['bound_by']}: {big['bytes']} B, "
            f"{big['flops']} flop; dense gram flops {larger[name][6]}); CUDA events kernel "
            f"{big['event_ms']:.4f} ms, wrapper {big['wrapper_event_ms']:.4f} ms"
        )
        row = dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches,
            max_abs_err=errs[name], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=m["library_ms"],
            launches_by_phase=by_phase, launches_per_iteration=launches / iters,
            launches_per_iteration_by_phase=per_iter, event_ms=m["event_ms"],
            wrapper_event_ms=m["wrapper_event_ms"], plain_event_ms=m["plain_event_ms"],
            at={label: {k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "event_ms", "wrapper_event_ms")}},
        )
        if dense_flops is not None:
            row["dense_flop_bound_ms"] = dense_flops / F32_FLOPS_PER_S * 1e3
        if name in FACTORS_PER_BLOCK:
            row.update(device_kernels_per_call=m["device_kernels_per_call"],
                       launch_floor_ms=floor_ms)
        rows.append(row)
    return rows


def profile_phase(label, phase):
    """One more f32 two-phase solve of the phase under torch.profiler: device
    busy time per LM iteration against the wall time per LM iteration of the
    unprofiled main-path run (the two runs' iteration counts differ: f32
    sums on the card change order from run to run), and the top device ops;
    at scale_1024 also the band solve's share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    problem32 = problem(np.float32, PHASES[label][0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, s1, s2, prof_wall = run_two_phase(problem32, plain=False)
    iters = s1.num_iterations + s2.num_iterations
    busy_ms = profile_summary(label, prof, prof_wall, iters, "LM iteration")
    if busy_ms <= 0:
        return
    wall_ms_per_iter = phase["wall"] * 1e3 / phase["iters"]
    print(f"profile {label}: busy share {busy_ms / iters / wall_ms_per_iter:.4f} of the "
          f"unprofiled {wall_ms_per_iter:.3f} ms per LM iteration")
    if phase["band_solves"]:
        band_ms = device_ms(lambda: band_solve.woodbury_band_solve(*phase["band_operands"]),
                            calls=5)
        n_ops = device_kernels_per_call(lambda: band_solve.woodbury_band_solve(
            *phase["band_operands"]), calls=3)
        d_tiles, _, z, _ = phase["band_operands"]
        per_iter = phase["band_solves"] / phase["iters"]
        cr = band_solve._use_cyclic_reduction(d_tiles.shape[0])
        print(
            f"profile {label}: band solve ({d_tiles.shape[0]} tiles of {d_tiles.shape[1]}, "
            f"rank {z.shape[0]}, cyclic reduction {cr}) "
            f"{band_ms:.3f} ms device time and {n_ops:.0f} device ops per call, "
            f"{per_iter:.2f} calls per LM iteration: {band_ms * per_iter / (busy_ms / iters):.4f} "
            f"of the device time per LM iteration"
        )


def check_session_gram(c):
    """K4 against its plain version at the session's last point-gram operand,
    in f32 and (the same values) in f64. Returns the f32 max abs error."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        cc = c.to(dtype)
        s4 = syrk.launch(cc)
        plain = syrk.syrk_gram_plain(cc)
        torch.cuda.synchronize()
        if not bool((s4 == s4.T).all()):
            raise AssertionError("syrk (session): output not exactly symmetric")
        errs[dtype] = _compare("syrk (session)", (s4,), (plain,), dtype, gram=True)
    print(f"gram vs plain: syrk at the session's operand (c {tuple(c.shape)}) max abs err "
          f"f64 {errs[torch.float64]:.3e}, f32 {errs[torch.float32]:.3e} - ok")
    return errs[torch.float32]


def check_session_reproj(state, cams, table):
    """K1 against its plain version at the session's largest reprojection
    table (a stereo window: two cameras, the second at a 0.12 m baseline), in
    f64 and in f32 (the same values): the table as captured, padded with
    masked garbage rows, its first row (n = 1) and every row masked; two
    launches equal bit for bit. Returns the f32 max abs error."""
    n_cam = cams.cam_from_robot_t.shape[0]
    on_second = int((table.mask & (table.cam_idx == 1)).sum())
    if n_cam < 2 or on_second == 0 or not bool((cams.cam_from_robot_t[1] != 0).any()):
        raise AssertionError(f"session reprojection table: {n_cam} cameras, {on_second} live "
                             "rows on a second camera with a non-zero translation")
    errs = {}
    for dtype in (torch.float64, torch.float32):
        s, c, t = (_cast(x, dtype) for x in (state, cams, table))
        padded = _ragged(t, 300, FACTORS_PER_BLOCK["reproj"])
        cases = {
            "as captured": t,
            f"padded to {padded.capacity}": padded,
            "n=1": _rows(t, 1),
            "all masked": _rows(padded, padded.capacity, live=False),
        }
        errs[dtype] = max(_factor_case("reproj", s, c, tt, dtype, f"session {case}")
                          for case, tt in cases.items())
        first, second = (ops.reproj_residuals_and_jac(s, c, padded) for _ in range(2))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError("reproj kernel: two launches on the session's table differ")
    print(f"kernel vs plain: reproj at the session's table ({table.capacity} rows, "
          f"{int(table.mask.sum())} live, {on_second} on camera 1 of {n_cam}, translation "
          f"{cams.cam_from_robot_t[1].tolist()}; padded, n=1, all masked; two launches bit for "
          f"bit) max abs err f64 {errs[torch.float64]:.3e}, f32 {errs[torch.float32]:.3e} - ok")
    return errs[torch.float32]


def main():
    t_start = time.perf_counter()
    preconditions()
    build()
    check_kernels(np.float64)
    errs = check_kernels(np.float32)
    check_grams(np.float64)
    gram_errs, gram_ops = check_grams(np.float32)
    errs.update(gram_errs)
    gram_tiles(gram_ops)
    for label in PHASES:
        check_step(label)
    for label, gate in BAND_CHECKS:
        check_band_vs_dense(label, gate)
    phases = {label: main_path_phase(label) for label in PHASES}
    fixed_iterations("global")
    fixed_iterations("scale_1024", n_iters=10)
    session = session_phase()
    errs["syrk"] = max(errs["syrk"], check_session_gram(session["syrk_operand"]))
    errs["reproj"] = max(errs["reproj"], check_session_reproj(*session["reproj_operands"]))
    rows = time_kernels(errs, phases, gram_ops, session)
    for label, ph in phases.items():
        profile_phase(label, ph)
    profile_session()
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
