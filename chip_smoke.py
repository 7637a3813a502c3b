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
    against an f64 run of the plain versions;
  - ``objects``: a 64-frame object-visual session
    (``synthetic_object_session``, stereo, 16 chairs along the path,
    drifting odometry), written at the start in the reference's input file
    formats (``synthetic.export_session_files``, with its config) and
    entered through the port's main entry point: ``build_session`` of
    ``obvi_slam_tpu_torch.cli.offline_object_visual_slam_main`` reads the
    files and wires the session as a user's run gets it (the feature-based
    bounding-box frontend and its pending-object mini-BAs, PGO with the
    objects on every global-BA frame and the final optimization, the
    post-session merge loop), in f32 through K1 and K2 (and
    K4 where a two-phase window BA meets its gate); checked by its
    trajectory error, one map object per chair within 0.5 m, the PGO
    records and timers, and an f64 run of the plain versions on the same
    files; then the marginal covariances through K1/K2 against the plain
    versions in f64, and the entry point's ``write_outputs`` with every
    output flag: the long-term map (every covariance finite and PSD, JSON
    out and in) and every artifact read back through the port's readers
    (the trajectory's ATE, the object metrics, the per-iteration CSVs, the
    timers, the checkpoints); a 16-frame second session, run by the entry
    point's ``main`` seeded from the map, must observe a map object again.
    K2 is then held against its plain version at the session's largest
    two-phase window BA table and a mini-BA table, and K1 at the mini-BA's
    empty reprojection table.

The two f64 plain sessions, and the second object session, run in
processes of their own on the same card (``chip_smoke.py
--session-process session|objects|second [args]``): the plain ones
from the start, the second one from when the map is saved, all joined at
the end. The plain object session alone takes about as long as the main
process's work, so every rate, time and profile of this script is taken
with the card and the host shared with them.

It prints LM iterations/s, both sessions' frames/s and ms per frame (the
object session's timer split too, and its seconds to read the input
files, to write the outputs and to extract the map), the
kernels' times, bounds and launch counts (K1 and K2 also with the device
kernels per wrapper call, which must be 1, and the launch floor: a
one-element ``torch.add``), each kernel also at the larger phases' shapes,
a profile of each synthetic phase (with the band solve's share at 1,024
poses) and of both sessions' last 8 frames (the object session's run on
from a copy of its state taken before them), one JSON line describing the
kernels, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. There is no CPU path.
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main  # noqa: E402
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
# The object session: 64 keyframes of a stereo rig, 16 chairs along the
# path, odometry that drifts (1 cm and 5 mrad of noise per step), the
# reference's default config with a chair prior and PGO on every global-BA
# frame (frames 1-50, 60 and 63 and the final optimization: the window of 50
# slides from frame 51, so frames 51-59, 61 and 62 run the two-phase window
# BA with the objects), written in the reference's file formats and read by
# the main entry point; then a 16-frame second session of the same scene
# (other noise) seeded from its long-term map, through the entry point's
# main. The last PROFILE_FRAMES online frames are profiled again from a
# copy of the session's state taken before them.
OBJECTS = dict(n_frames=64, n_features=1200, n_objects=16, seed=21, baseline=0.12,
               odom_noise=0.01)
PROFILE_FRAMES = 8
OBJECTS_SECOND = dict(OBJECTS, n_frames=16, seed=99)
OBJECTS_KERNELS = ("reproj", "bbox")
OBJECT_TIMERS = ("frame_data_adder", "refine_initial_estimate_for_pending_objects",
                 "obj_only_pgo_full_process", "post_session_map_merge", "ltm_extraction")
PGO_TIMERS = ("obj_only_pgo_full_process", "obj_only_pgo_local_track_solve",
              "obj_only_pgo_solve_pgo", "obj_only_pgo_opt_feat_adjust_solve")
CHAIR_PRIOR = ([0.62, 0.62, 0.975], [0.05, 0.05, 0.05])  # mean, std per axis
# The main entry point's output flags and their names in an output directory;
# the per-iteration CSV types and checkpoints the object session must write.
OUTPUTS = {
    "--long_term_map_output": "ltm.json",
    "--robot_poses_results_file": "robot_poses.csv",
    "--ellipsoids_results_file": "ellipsoids.csv",
    "--visual_feature_results_file": "features.csv",
    "--opt_log_file": "ceres_opt_summary.csv",
    "--timing_report_file": "timing.json",
    "--bb_associations_out_file": "bb_assoc.json",
    "--checkpoint_output_dir": "checkpoints",
    "--logs_directory": "logs",
}
OPTLOG_TYPES = ("pending_obj_est", "pgo", "pre_pgo_track", "vf_adjust", "lba_phase_1",
                "lba_phase_2", "gba_phase_2")
CHECKPOINTS = (f"pose_graph_state_checkpoint_pre_optimization_{OBJECTS['n_frames'] - 1}_attempt_1",
               "pose_graph_state_checkpoint_post_frame_add",
               "pose_graph_state_checkpoint_post_postprocessing", "long_term_map_checkpoint",
               "pose_graph_state")
# Marginal covariances, K1/K2 against their plain versions, f64: each 7x7
# block within this much of its largest entry.
COV_TOLERANCE = 1e-6
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


def _drive(runner, data, pg, visual_frontend, n_frames, profile_frames=None, start=0,
           before_frame=None):
    """runner.run_optimization from online frame ``start`` with per-frame
    times and ``profile_frames`` (a range of online frames) under
    torch.profiler; ``before_frame(frame)`` is called before each frame's
    data adding, untimed. Returns a dict: runner, pg, seconds per online
    frame (data adding + optimization, frames max(1, start)..N-1), seconds of
    the final optimization (with the merge loop) and of the online portion,
    and (profile, wall s of the profiled frames) or None."""
    from torch.profiler import ProfilerActivity, profile

    frame_s, prof, prof_t, untimed = {}, None, [], [0.0]
    add, iterate = runner.add_frame_data, runner.run_optimization_iteration

    def timed_add(data_, pg_, lo, frame):
        nonlocal prof
        if before_frame is not None:
            t0 = time.perf_counter()
            before_frame(frame)
            untimed[0] += time.perf_counter() - t0
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
    if not runner.run_optimization(data, pg, visual_frontend=visual_frontend,
                                   start_at_frame=start):
        raise AssertionError("run_optimization returned False")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0 - untimed[0]
    return dict(
        runner=runner, pg=pg, online=[frame_s[f] for f in range(max(1, start), n_frames)],
        final_s=frame_s["final"], online_s=total - frame_s["final"],
        profile=None if prof is None else (prof, prof_t[1] - prof_t[0]),
    )


def _snapshot_at(frame_at, out, runner, *state):
    """A ``before_frame`` for ``_drive``: at online frame ``frame_at``, a copy
    of the runner's caps pools and solve log and of ``state`` into ``out``."""
    def before_frame(frame):
        if frame == frame_at:
            out.append(copy.deepcopy((runner._caps_pools, runner.opt_log, *state)))
    return before_frame


def _resume(run, runner, profile_frames):
    """``run``'s session run on by ``runner`` from the copy ``_snapshot_at``
    took at frame ``profile_frames[0]`` (which it uses up), through the
    final optimization, with ``profile_frames`` under torch.profiler."""
    pools, log, pg, vf = run["snapshot"][:4]
    data = run["data"]
    runner._caps_pools, runner.opt_log = pools, log
    vf.gba_checker = lambda f: runner._gba_checker(f, data.max_frame_id())
    return _drive(runner, data, pg, vf, data.max_frame_id() + 1, profile_frames,
                  start=profile_frames[0])


def run_session(dtype, plain, snapshot_at=None):
    """One visual-only OfflineProblemRunner session at the reference's
    default config (see ``_drive``), with the ground truth, the odometry's
    ATE and the copy of its state taken before online frame ``snapshot_at``
    (or None)."""
    data, gt, _ = ot.synthetic_session(**SESSION)
    runner = ot.OfflineProblemRunner(
        ot.config.FullOVSLAMConfig(), dtype=dtype, device=DEVICE, plain=plain
    )
    pg = ot.PoseGraph(data.cameras)
    vf, snapshot = visual_frontend_for(runner, data), []
    run = _drive(runner, data, pg, vf, SESSION["n_frames"],
                 before_frame=_snapshot_at(snapshot_at, snapshot, runner, pg, vf))
    return dict(run, gt=gt, odom_ate=_ate(data.initial_poses, gt), data=data,
                snapshot=snapshot[0] if snapshot else None)


def session_phase():
    """The session in f32 through the kernels, between a reset and a read of
    the launch counts, with K1's and K4's operands captured; its trajectory error
    against the odometry's (tests/test_runner_e2e.py:168-173). The same
    session in f64 through the plain versions runs in a session process
    (``check_session_processes``)."""
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
            run = run_session(np.float32, False,
                              snapshot_at=SESSION["n_frames"] - PROFILE_FRAMES)
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

    return dict(launches=launches, iters=iters, wall=online_s + run["final_s"],
                syrk_operand=kept[0], reproj_operands=reproj_kept[0],
                frames_per_s=len(online) / online_s, ate=ate, run=run)


def object_config():
    """The reference's default config with a chair shape prior and PGO on
    every global-BA frame (and on the final one), as the paper config runs.
    PGO takes the place of the visual global BA there, so the session runs
    no global two-phase BA: its gba_phase_2 iteration CSV holds the PGO
    solves (the reference logs them under that type too) and it writes no
    gba_phase_1 CSV."""
    config = ot.config.FullOVSLAMConfig()
    mean, std = CHAIR_PRIOR
    config.shape_dimension_priors = [ot.config.ShapeDimensionPrior(
        "chair", np.array(mean), np.diag(np.array(std) ** 2))]
    en = config.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = True
    en.use_pose_graph_on_final_global_ba = True
    return config


def export_object_sessions(root):
    """The object session (OBJECTS) and the second session (OBJECTS_SECOND)
    written in the reference's input formats, each with its config, under
    ``root``: {label: (directory, ground-truth poses, ground-truth
    objects)}."""
    from obvi_slam_tpu_torch.synthetic import export_session_files

    t0 = time.perf_counter()
    out = {}
    for label, size in (("objects", OBJECTS), ("second", OBJECTS_SECOND)):
        data, gt, gt_objects = ot.synthetic_object_session(**size)
        d = export_session_files(data, gt, Path(root) / label)
        ot.config.write_config(object_config(), str(d / "config.json"))
        out[label] = (d, gt, gt_objects)
    print(f"object sessions drawn and written in the reference's file formats in "
          f"{time.perf_counter() - t0:.2f} s")
    return out


def object_argv(directory, *extra):
    """The main entry point's flags for the exported session in
    ``directory`` on the card (f32 unless ``extra`` holds --f64)."""
    d = Path(directory)
    return ["--params_config_file", str(d / "config.json"),
            "--intrinsics_file", str(d / "intrinsics.csv"),
            "--extrinsics_file", str(d / "extrinsics.csv"),
            "--poses_by_node_id_file", str(d / "poses.csv"),
            "--bounding_boxes_by_node_id_file", str(d / "bounding_boxes.csv"),
            "--low_level_feats_dir", str(d / "orb_out"), "--device", DEVICE, *extra]


def output_argv(out):
    """Every output flag of the main entry point, into directory ``out``."""
    return [arg for flag, name in OUTPUTS.items() for arg in (flag, str(Path(out) / name))]


def run_objects(args, plain, gt, gt_objects=None, stage=None, snapshot_at=None):
    """One object session, built by the main entry point's ``build_session``
    from the files ``args`` names (config, data, pose graph, bounding-box
    frontend, hooks, runner and visual frontend as a user's run gets them;
    ``plain`` the kernels' plain versions), driven by ``_drive``.
    ``stage[0]`` reads "mini-BA" inside a pending-object mini-BA, "window"
    inside a two-phase window BA, else None. At online frame
    ``snapshot_at`` a copy of the session's state is taken before the
    frame's data adding (``_resume`` runs on from it). Adds the session,
    the ground truth, the odometry's ATE, the frontend, the mini-BAs' (calls,
    LM iterations), the two-phase window BAs and the snapshot (or None)."""
    from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf

    stage = [None] if stage is None else stage
    session = cli_main.build_session(args, plain=plain)
    runner, data, pg, fe = session.runner, session.data, session.pg, session.bb_frontend
    vf = session.visual_frontend
    mini, windows, snapshot = [0, 0], [0], []
    inner, two_phase = bbf.solve, runner._solve_two_phase

    def counted(*a, **k):
        stage[0] = "mini-BA"
        try:
            out = inner(*a, **k)
        finally:
            stage[0] = None
        mini[0] += 1
        mini[1] += out[1].num_iterations
        return out

    def window_ba(*a, **k):
        stage[0] = "window"
        try:
            return two_phase(*a, **k)
        finally:
            stage[0] = None
            windows[0] += 1

    bbf.solve, runner._solve_two_phase = counted, window_ba
    try:
        run = _drive(runner, data, pg, vf, data.max_frame_id() + 1,
                     before_frame=_snapshot_at(snapshot_at, snapshot, runner, pg, vf, fe))
    finally:
        bbf.solve = inner
    return dict(run, session=session, gt=gt, gt_objects=gt_objects,
                odom_ate=_ate(data.initial_poses, gt), frontend=fe, mini_ba=tuple(mini),
                window_bas=windows[0], config=session.config, data=data,
                snapshot=snapshot[0] if snapshot else None)


def read_gt_poses(directory):
    """The exported session's ground-truth trajectory, read back."""
    from obvi_slam_tpu_torch import io as pio

    poses = pio.read_poses_by_node_id(str(Path(directory) / "gt_poses.csv"))
    return np.stack([poses[i] for i in sorted(poses)])


def _object_matches(pg, gt_objects, radius=0.5):
    """Map objects within ``radius`` of each ground-truth object's centre."""
    centres = np.array([node.ellipsoid[:3] for node in pg.objects.values()]).reshape(-1, 3)
    return [int((np.linalg.norm(centres - g[:3], axis=1) < radius).sum()) for g in gt_objects]


def _copy_args(state, cams, f):
    return tuple(type(x)(*(t.clone() for t in x)) for x in (state, cams, f))


def check_marginals(pg, config):
    """compute_marginal_covariances on the session's final pose graph (the
    extraction problem in f64, with the repair priors the plain run's
    reduced Hessian calls for): through K1/K2 against the plain versions.
    Each 7x7 block within COV_TOLERANCE of its largest entry. Returns the
    worst such relative error and the reduced system's size."""
    from obvi_slam_tpu_torch import ltm as ltm_mod
    from obvi_slam_tpu_torch import types as T
    from obvi_slam_tpu_torch.solver.problem import build_problem

    problem = build_problem(
        pg, ltm_mod._extraction_scope(pg.max_frame_id(), config),
        config.ltm_solver_residual_params, dtype=np.float64, device=DEVICE)
    p = problem
    args = (p.state, p.cams, p.tables, p.plan, p.free, p.weights, p.huber)
    _, _, _, red_h = schur_mod.compute_marginal_covariances(
        *args, return_reduced_hessian=True, plain=True)
    state_np = {"pose": p.state.poses.cpu().numpy(), "object": p.state.objects.cpu().numpy()}
    deficient = ltm_mod.find_rank_deficiencies(
        red_h.cpu().numpy(), state_np, config.ltm_tunable_params.min_col_norm)
    tables = p.tables
    if deficient:
        tables = tables._replace(param_prior=T.make_param_prior_factors(
            *([d[k] for d in deficient] for k in range(5)), dtype=np.float64, device=DEVICE))
    args = (p.state, p.cams, tables, p.plan, p.free, p.weights, p.huber)
    ops.reset_kernel_launches()
    covs_k, _, ok_k = schur_mod.compute_marginal_covariances(*args)
    launched = ops.kernel_launches()
    covs_p, _, ok_p = schur_mod.compute_marginal_covariances(*args, plain=True)
    torch.cuda.synchronize()
    if not (bool(ok_k) and bool(ok_p)):
        raise AssertionError(f"marginal covariances: ok kernels {bool(ok_k)}, plain {bool(ok_p)}")
    if not (launched["reproj"] and launched["bbox"]):
        raise AssertionError(f"marginal covariances launched {launched}")
    n_obj = len(p.obj_rows)
    a, b = covs_k[:n_obj], covs_p[:n_obj]
    scale = b.abs().amax(dim=(1, 2))
    err = float(((a - b).abs().amax(dim=(1, 2)) / scale).max())
    print(f"marginal covariances (f64, {red_h.shape[0]} x {red_h.shape[0]} reduced system, "
          f"{n_obj} objects, {len(deficient)} repair priors): K1/K2 against the plain "
          f"versions, max abs error per block over its largest entry {err:.3e} (limit "
          f"{COV_TOLERANCE:g}); launches {launched}")
    if not err <= COV_TOLERANCE:
        raise AssertionError(f"marginal covariances: kernel vs plain {err:.3e}")
    return err, red_h.shape[0]


def _compare_f32_rounding(name, kernel_out, plain_out, exact_out, live):
    """f32 kernel against its f32 plain version where the inputs make f32
    itself inexact: in each factor row of each output, the max abs error
    within the larger of 1e-4 of the output's largest entry (the f32 rule of
    ``_compare``) and 4x the plain f32 version's own max abs error against
    the f64 plain version on the same values in that row. Masked rows
    exactly 0. Returns, worst over the outputs: the max abs error, the
    largest 1e-4 floor, the largest plain f32 and kernel errors against f64
    in a row, and the largest ratio of a row's error to its limit."""
    worst = dict(err=0.0, floor=0.0, plain_err=0.0, kernel_err=0.0, ratio=0.0)
    for k, (a, b, x) in enumerate(zip(kernel_out, plain_out, exact_out)):
        if not bool((a[~live] == 0).all()):
            raise AssertionError(f"{name} output {k}: masked rows not exactly zero")
        n = a.shape[0]
        row_err = (a - b).abs().reshape(n, -1).amax(dim=1).double()
        row_plain = (b.double() - x).abs().reshape(n, -1).amax(dim=1)
        row_kernel = (a.double() - x).abs().reshape(n, -1).amax(dim=1)
        floor = 1e-4 * float(b.abs().max())
        limit = torch.clamp(4.0 * row_plain, min=floor)
        ratio = torch.where(row_err == 0, torch.zeros_like(row_err), row_err / limit)
        r = int(ratio.argmax())
        if not float(ratio[r]) <= 1.0:
            raise AssertionError(
                f"{name} f32 output {k} row {r}: max abs err {float(row_err[r]):.3e} > "
                f"{float(limit[r]):.3e} (1e-4 floor {floor:.3e}, plain f32 against f64 in "
                f"that row {float(row_plain[r]):.3e}, kernel f32 against f64 "
                f"{float(row_kernel[r]):.3e})")
        worst = dict(err=max(worst["err"], float(row_err.max())),
                     floor=max(worst["floor"], floor),
                     plain_err=max(worst["plain_err"], float(row_plain.max())),
                     kernel_err=max(worst["kernel_err"], float(row_kernel.max())),
                     ratio=max(worst["ratio"], float(ratio[r])))
    return worst


def check_object_tables(window, mini, mini_reproj):
    """K2 against its plain version at the object session's largest
    two-phase window BA bbox table and at its largest mini-BA table, in f64
    (the f64 tolerance) and f32 (the same values; ``_compare_f32_rounding``:
    near a mini-BA's optimum the residuals are small differences that f32
    rounds; its floor, plain error and worst row are printed), with the
    invalid-ellipse value the solve used; the mini-BA table's K1 call (its
    empty reprojection table: one row, none live) too. Returns the f32 max
    abs errors (bbox, reproj)."""
    errs, rounding = {"bbox": {}, "reproj": {}}, {}
    for dtype in (torch.float64, torch.float32):
        for label, (state, cams, table, invalid) in (("window", window), ("mini-BA", mini)):
            s, c, t = (_cast(x, dtype) for x in (state, cams, table))
            out_k = ops.bbox_residuals_and_jac(s, c, t, invalid)
            out_p = fac.bbox_residuals_and_jac(s, c, t, invalid)
            torch.cuda.synchronize()
            name = f"bbox objects {label}"
            if dtype == torch.float64:
                errs["bbox"][(label, dtype)] = _compare(name, out_k, out_p, dtype, t.mask)
            else:
                exact = fac.bbox_residuals_and_jac(*(_cast(x, torch.float64) for x in (s, c, t)),
                                                   invalid)
                rounding[label] = _compare_f32_rounding(name, out_k, out_p, exact, t.mask)
                errs["bbox"][(label, dtype)] = rounding[label]["err"]
        state, cams, rp = mini_reproj
        if rp.capacity < 1 or bool(rp.mask.any()) or state.points.shape[0] != 1:
            raise AssertionError(f"mini-BA reprojection table: {rp.capacity} rows, "
                                 f"{int(rp.mask.sum())} live, {state.points.shape[0]} points")
        errs["reproj"][dtype] = _factor_case(
            "reproj", *(_cast(x, dtype) for x in (state, cams, rp)), dtype,
            "mini-BA (no live rows)")
    w, m = window[2], mini[2]
    print(f"kernel vs plain: bbox at the object session's window table ({w.capacity} rows, "
          f"{int(w.mask.sum())} live, {window[1].fx.shape[0]} cameras, {window[0].poses.shape[0]} "
          f"poses, {window[0].objects.shape[0]} objects) and at a mini-BA table ({m.capacity} rows, "
          f"{int(m.mask.sum())} live, invalid value {mini[3]:g}): max abs err "
          + ", ".join(f"{lbl} {str(dt).split('.')[-1]} {e:.3e}"
                      for (lbl, dt), e in errs["bbox"].items())
          + f"; reproj at the mini-BA's empty table f64 {errs['reproj'][torch.float64]:.3e}, "
          f"f32 {errs['reproj'][torch.float32]:.3e} - ok")
    for label, r in rounding.items():
        print(f"kernel vs plain: bbox f32 at the object session's {label} table: max abs err "
              f"{r['err']:.3e}; 1e-4 floor {r['floor']:.3e}; plain f32 against f64 {r['plain_err']:.3e}, "
              f"kernel f32 against f64 {r['kernel_err']:.3e} (largest in a row); worst row at "
              f"{r['ratio']:.3f} of its limit")
    f32 = torch.float32
    return max(errs["bbox"][("window", f32)], errs["bbox"][("mini-BA", f32)]), errs["reproj"][f32]


def objects_phase(tmp, exported):
    """The object session in f32 through the kernels, entered through the
    main entry point (``build_session`` on the exported files in
    ``exported``), between a reset and a read of the launch counts, with
    K2's operands captured at the largest table of a two-phase window BA and
    of a mini-BA (and K1's at the mini-BA's empty reprojection table); its
    gates (trajectory, objects, PGO, two-phase window BAs, launches); the
    marginal covariances against the plain versions; then the entry point's
    ``write_outputs`` with every output flag set (into directory ``tmp``):
    the long-term map (finite, PSD, unchanged through JSON) and every
    artifact read back (``check_object_outputs``). The same session in f64
    through the plain versions, and the second session seeded from the map,
    run in session processes (``check_session_processes``)."""
    directory, gt, gt_objects = exported
    out = Path(tmp) / "objects_out"
    args = cli_main.parse_args(object_argv(directory, *output_argv(out)))
    bbox_inner, reproj_inner = ops.bbox_residuals_and_jac, ops.reproj_residuals_and_jac
    window, mini, mini_reproj, stage = [], [], [], [None]

    def bbox_spy(state, cams, f, invalid_error=1e6):
        keep = {"window": window, "mini-BA": mini}.get(stage[0])
        if keep is not None and (not keep or f.capacity > keep[0][2].capacity):
            keep[:] = [(*_copy_args(state, cams, f), invalid_error)]
        return bbox_inner(state, cams, f, invalid_error)

    def reproj_spy(state, cams, f):
        if stage[0] == "mini-BA" and not mini_reproj:
            mini_reproj.append(_copy_args(state, cams, f))
        return reproj_inner(state, cams, f)

    n_frames = OBJECTS["n_frames"]
    ops.bbox_residuals_and_jac, ops.reproj_residuals_and_jac = bbox_spy, reproj_spy
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_kernel_launches()
        run = run_objects(args, False, gt, gt_objects, stage=stage,
                          snapshot_at=n_frames - PROFILE_FRAMES)
        launches = ops.kernel_launches()
    finally:
        ops.bbox_residuals_and_jac, ops.reproj_residuals_and_jac = bbox_inner, reproj_inner
    peak = torch.cuda.max_memory_allocated()
    runner, pg, online, online_s = run["runner"], run["pg"], run["online"], run["online_s"]
    ate = _ate([pg.get_robot_pose(i) for i in range(n_frames)], run["gt"])
    odom = run["odom_ate"]
    log = runner.opt_log
    iters = sum(r.iterations for r in log)
    matches = _object_matches(pg, run["gt_objects"])
    config = run["config"]
    card = card_line()
    print(
        f"objects ({n_frames} frames, {OBJECTS['n_features']} features generated, "
        f"{len(run['data'].feature_tracks)} tracks read, {len(pg.features)} admitted, "
        f"{OBJECTS['n_objects']} chairs, stereo at {OBJECTS['baseline']} m; window "
        f"{config.sliding_window_params.local_ba_window_size}, global BA every "
        f"{config.sliding_window_params.global_ba_frequency}, PGO on global BA; built by "
        f"the main entry point from files) on {card}: "
        f"{len(log)} solves ({sum(r.phase == 0 for r in log)} PGO, {run['window_bas']} "
        f"two-phase window BAs), {iters} LM iterations, mini-BAs {run['mini_ba'][0]} with "
        f"{run['mini_ba'][1]} LM iterations; {len(pg.objects)} objects, "
        f"{len(pg.merged_objects)} merged; ATE {ate:.6f} m (odometry {odom:.6f} m); peak "
        f"device memory {peak} B"
    )
    print(
        f"objects f32 kernels on {card}: online portion {online_s:.4f} s, "
        f"{len(online) / online_s:.3f} frames/s; ms per frame median "
        f"{statistics.median(online) * 1e3:.2f}, p90 {float(np.percentile(online, 90)) * 1e3:.2f}, "
        f"max {max(online) * 1e3:.2f}; final optimization and merge loop "
        f"{run['final_s']:.4f} s; launches {launches}, bbox {launches['bbox'] / n_frames:.2f} "
        f"per frame"
    )
    for r in log:
        if r.termination not in TERMINATION_NAMES.values():
            raise AssertionError(f"objects frame {r.frame_id}: termination {r.termination}")
    if not (ate < 0.5 * odom and ate < 0.05):
        raise AssertionError(f"objects ATE {ate:.6f} m: not below half the odometry's "
                             f"({odom:.6f} m) and 0.05 m")
    if matches != [1] * len(matches):
        raise AssertionError(f"objects: map objects within 0.5 m of each chair {matches}")
    timers = TimerRegistry.instance().summary()
    if not any(r.phase == 0 for r in log) or not all(t in timers for t in PGO_TIMERS):
        raise AssertionError(f"objects: PGO did not run (timers {sorted(timers)})")
    for name in OBJECTS_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the objects phase")
    if not (run["window_bas"] and window and mini and mini_reproj):
        raise AssertionError(f"objects: {run['window_bas']} two-phase window BAs; window, "
                             "mini-BA or mini-BA reprojection table not captured")

    cov_err, cov_dim = check_marginals(pg, config)
    t0 = time.perf_counter()
    ltm = cli_main.write_outputs(run["session"])
    write_s = time.perf_counter() - t0
    if ltm is None or len(ltm.covariances) != len(pg.objects):
        raise AssertionError("objects: LTM extraction failed")
    min_eig = []
    for obj, cov in ltm.covariances.items():
        w = np.linalg.eigvalsh(0.5 * (cov + cov.T))
        min_eig.append(float(w.min() / w.max()))
        if not (np.all(np.isfinite(cov)) and w.min() >= -1e-12 * w.max()):
            raise AssertionError(f"objects: LTM covariance of object {obj} not finite PSD {w}")
    loaded = ot.LongTermObjectMap.load(args.long_term_map_output)
    if loaded.ellipsoids.keys() != ltm.ellipsoids.keys() or any(
            not np.array_equal(loaded.covariances[k], c) for k, c in ltm.covariances.items()):
        raise AssertionError("objects: LTM changed through JSON")
    timers = TimerRegistry.instance().summary()
    print(f"objects f32 timers on {card}: " + "; ".join(
        f"{name} {timers[name]['total_s']:.4f} s in {timers[name]['invocations']} calls"
        for name in OBJECT_TIMERS if name in timers))
    for name, t in sorted(timers.items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"  timer {name}: {t['total_s']:.4f} s in {t['invocations']} calls")
    print(f"objects LTM: {len(ltm.ellipsoids)} objects, covariances finite and PSD (smallest "
          f"eigenvalue over largest per object from {min(min_eig):.3e} to {max(min_eig):.3e}), "
          "saved as JSON and loaded")
    ltm_s = timers["ltm_extraction"]["total_s"]
    check_object_outputs(out, pg, run, ate)
    print(f"objects entry point I/O on {card}: inputs read in {run['session'].read_s:.4f} s; "
          f"outputs written in {write_s - ltm_s:.4f} s besides the LTM extraction "
          f"({ltm_s:.4f} s)")
    return dict(launches=launches, iters=iters, wall=online_s + run["final_s"],
                window=window[0], mini=mini[0], mini_reproj=mini_reproj[0],
                frames_per_s=len(online) / online_s, ate=ate, run=run,
                cov_err=cov_err, cov_dim=cov_dim, ltm_path=args.long_term_map_output,
                ltm_objects=sorted(loaded.ellipsoids))


def check_object_outputs(out, pg, run, ate):
    """Every artifact of ``write_outputs`` in ``out``, read back through
    the port's readers: the trajectory's ATE (``metrics``) equal to the
    in-memory ATE within 1e-9 m; the ellipsoids' object metrics with recall
    1.0 over the chairs; the association results and the LTM loading; each
    optimization logger type's CSV with the reference's header; the timers;
    the checkpoints."""
    from obvi_slam_tpu_torch import io as pio
    from obvi_slam_tpu_torch import metrics
    from obvi_slam_tpu_torch.io.writers import read_ellipsoid_results
    from obvi_slam_tpu_torch.optlog import _HEADER

    out = Path(out)
    gt = run["gt"]
    poses = pio.read_poses_by_node_id(str(out / "robot_poses.csv"))
    est = np.stack([poses[i] for i in range(len(gt))])
    file_ate = metrics.ate_for_synced_aligned(est, gt).rmse_transl_err
    if not abs(file_ate - ate) <= 1e-9:
        raise AssertionError(f"objects: ATE from robot_poses.csv {file_ate!r} vs {ate!r}")
    est_objects = read_ellipsoid_results(str(out / "ellipsoids.csv"))
    gt_objects = {k: ("chair", e) for k, e in enumerate(run["gt_objects"])}
    om = metrics.object_metrics(est_objects, gt_objects, max_assoc_dist=0.5)
    if om.recall != 1.0 or om.num_gt_objs != len(gt_objects):
        raise AssertionError(f"objects: recall {om.recall} over {om.num_gt_objs} chairs")
    assoc_objects, _ = pio.read_bb_association_results(str(out / "bb_assoc.json"))
    n_features = len((out / "features.csv").read_text().strip().splitlines()) - 1
    if sorted(assoc_objects) != sorted(pg.objects) or n_features != len(pg.features):
        raise AssertionError("objects: bb_assoc.json or features.csv do not hold the map")
    ot.LongTermObjectMap.load(str(out / "ltm.json"))
    for t in OPTLOG_TYPES:
        path = out / "logs" / f"ceres_iterations_{t}.csv"
        lines = path.read_text().splitlines() if path.exists() else []
        if len(lines) < 2 or lines[0] != _HEADER:
            raise AssertionError(f"objects: {path.name} missing, empty or with another header")
    timing = json.loads((out / "timing.json").read_text())
    missing = [t for t in OBJECT_TIMERS if t not in timing]
    names = {p.stem for p in (out / "checkpoints").glob("*.json")}
    if missing or not set(CHECKPOINTS) <= names:
        raise AssertionError(f"objects: timers {missing} or checkpoints "
                             f"{sorted(set(CHECKPOINTS) - names)} missing")
    print(f"objects outputs read back: ATE from robot_poses.csv {file_ate:.6f} m (in memory "
          f"{ate:.6f} m, difference {abs(file_ate - ate):.3e}); object recall {om.recall} over "
          f"{om.num_gt_objs} chairs, mean position deviation {om.average_pos_deviation:.4f} m, "
          f"mean IoU {om.avg_iou:.4f}; {len(assoc_objects)} objects in bb_assoc.json, "
          f"{n_features} features; LTM loads; {len(OPTLOG_TYPES)} per-iteration CSVs; "
          f"timing.json with {len(timing)} timers; {len(names)} checkpoints")


def profile_objects(run):
    """The f32 object session's last PROFILE_FRAMES online frames again,
    run on from the copy of its state taken before them (``_resume``), under
    torch.profiler (as profile_session): a fresh session from the main entry
    point, its bounding-box frontend given the copy's state."""
    last = OBJECTS["n_frames"]
    frames = range(last - PROFILE_FRAMES, last)
    args = copy.copy(run["session"].args)
    args.checkpoint_output_dir = args.logs_directory = ""
    fresh = cli_main.build_session(args)
    fresh.bb_frontend.__dict__.update(run["snapshot"][4].__dict__)
    prof, wall = _resume(run, fresh.runner, frames)["profile"]
    profile_summary(f"objects frames {frames[0]}-{frames[-1]}", prof, wall, PROFILE_FRAMES,
                    "frame")


def profile_session(run):
    """The f32 session's last PROFILE_FRAMES online frames again, run on
    from the copy of its state taken before them (``_resume``), under
    torch.profiler: device busy time, kernels and busy share per frame. Runs
    after the kernel timings: a profile of this many device ops can leave
    later profiler windows short of kernel records."""
    last = SESSION["n_frames"]
    frames = range(last - PROFILE_FRAMES, last)
    runner = ot.OfflineProblemRunner(ot.config.FullOVSLAMConfig(), dtype=np.float32,
                                     device=DEVICE, plain=False)
    prof, wall = _resume(run, runner, frames)["profile"]
    profile_summary(f"session frames {frames[0]}-{frames[-1]}", prof, wall, PROFILE_FRAMES,
                    "frame")


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
    over ``calls`` calls (in up to three profiler windows, until one sees
    device time). 0.0 when none does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total_us = 0.0
    for _ in range(3):  # a profiler window on a busy host can lose its kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and (match is None or match in e.key)
        )
        if total_us > 0:
            break
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


def _bbox_case(state, cams, bb, invalid_error=1e6):
    """K2's (kernel, wrapper, plain, library, inputs, flops, dense flops)."""
    cam_r, cam_t = cams.cam_from_robot_r, cams.cam_from_robot_t
    return (
        lambda: k_bbox.launch(state.objects, state.poses, cam_r, cam_t, bb, invalid_error),
        lambda: ops.bbox_residuals_and_jac(state, cams, bb, invalid_error),
        lambda: fac.bbox_residuals_and_jac(state, cams, bb, invalid_error),
        None,
        (state.objects, state.poses, cam_r, cam_t, bb.obj_idx, bb.pose_idx, bb.cam_idx,
         bb.rect_corners, bb.sqrt_inf, bb.mask),
        FLOPS_PER_FACTOR["bbox"] * int(bb.mask.sum()), None,
    )


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
        "bbox": _bbox_case(state, cams, bb),
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


def time_kernels(errs, phases, gram_ops, session, objects):
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
    data); the dense count is printed beside. K2 is also timed at the object
    session's largest window table (under ``at``, "objects")."""
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
    all_phases = dict(phases, session=session, objects=objects)
    o_state, o_cams, o_bbox = (_cast(x, torch.float32) for x in objects["window"][:3])
    objects_case = _bbox_case(o_state, o_cams, o_bbox, objects["window"][3])
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
        at = {label: {k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "event_ms", "wrapper_event_ms")}}
        if name == "bbox":
            ob = _measure(name, *objects_case[:6])
            print(
                f"kernel bbox at the objects window table ({o_bbox.capacity} rows, "
                f"{int(o_bbox.mask.sum())} live): {ob['ms']:.5f} ms per launch, plain "
                f"{ob['plain_ms']:.5f} ms ({ob['source']}); bound {ob['bound_ms'] * 1e3:.4f} us "
                f"({ob['bound_by']}: {ob['bytes']} B, {ob['flops']} flop); CUDA events kernel "
                f"{ob['event_ms']:.4f} ms, wrapper {ob['wrapper_event_ms']:.4f} ms"
            )
            at["objects"] = {k: ob[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "event_ms", "wrapper_event_ms")}
        row = dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches,
            max_abs_err=errs[name], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=m["library_ms"],
            launches_by_phase=by_phase, launches_per_iteration=launches / iters,
            launches_per_iteration_by_phase=per_iter, event_ms=m["event_ms"],
            wrapper_event_ms=m["wrapper_event_ms"], plain_event_ms=m["plain_event_ms"],
            at=at,
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


SESSION_PROCESS_ARG = "--session-process"


def session_process(label, *args):
    """The body of a session process. ``label`` "session": the visual
    session in f64 through the plain versions; "objects": the object session
    exported in directory ``args[0]``, read by the main entry point's
    ``build_session(..., plain=True)`` in f64, the reference of that phase's
    trajectory gate; "second": the main entry point's ``main`` on the second
    session exported in ``args[0]``, in f32 through the kernels, seeded from
    the long-term map at ``args[1]``, writing every output into ``args[2]``.
    Prints, as its last line, one JSON object with the session's ATE,
    objects, map objects observed again (the second session: read from its
    files), solves, LM iterations, times and kernel launches."""
    preconditions()
    torch.set_num_threads(2)
    ops.reset_kernel_launches()
    if label == "second":
        print(json.dumps(second_session(*args)))
        return
    if label == "session":
        run, n_frames = run_session(np.float64, True), SESSION["n_frames"]
    else:
        gt = read_gt_poses(args[0])
        run = run_objects(cli_main.parse_args(object_argv(args[0], "--f64")), True, gt)
        n_frames = len(gt)
    pg, log = run["pg"], run["runner"].opt_log
    print(json.dumps(dict(
        ate=_ate([pg.get_robot_pose(i) for i in range(n_frames)], run["gt"]),
        objects=len(pg.objects), merged=len(pg.merged_objects), again=[],
        solves=len(log), iterations=sum(x.iterations for x in log),
        online_s=run["online_s"], final_s=run["final_s"],
        mini_ba=list(run.get("mini_ba", (0, 0))), launches=ops.kernel_launches())))


def second_session(directory, ltm_path, out):
    """The main entry point's ``main`` on the second session, seeded from
    the map; what it did, read from its output files."""
    from obvi_slam_tpu_torch import io as pio

    argv = object_argv(directory, "--long_term_map_input", ltm_path, *output_argv(out))
    if cli_main.main(argv) != 0:
        raise RuntimeError("the second session's main returned non-zero")
    out = Path(out)
    ltm = ot.LongTermObjectMap.load(ltm_path)
    objects, assoc = pio.read_bb_association_results(str(out / "bb_assoc.json"))
    state = json.loads((out / "checkpoints" / "pose_graph_state.json").read_text())
    timing = json.loads((out / "timing.json").read_text())
    rows = [r.split(",") for r in (out / "ceres_opt_summary.csv").read_text().splitlines()[1:]]
    poses = pio.read_poses_by_node_id(str(out / "robot_poses.csv"))
    gt = read_gt_poses(directory)
    return dict(
        ate=_ate(poses, gt), objects=len(objects), merged=len(state["merged_objects"]),
        again=sorted(o for o in ltm.ellipsoids if assoc.get(o)), solves=len(rows),
        iterations=sum(int(r[9]) for r in rows),
        online_s=timing["offline_runner_online_portion"]["total_s"],
        final_s=timing["offline_runner_offline_portion"]["total_s"], mini_ba=[0, 0],
        launches=ops.kernel_launches())


def start_session_process(label, *args):
    """``session_process(label, *args)`` in a process of its own on the same
    card, beside the main path: (process, stdout file, stderr file)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), SESSION_PROCESS_ARG, label, *args],
        stdout=out, stderr=err, cwd=str(REPO))
    return proc, out, err


def join_session_processes(workers):
    """Waits for the session processes; returns {label: JSON object}."""
    t0 = time.perf_counter()
    results = {}
    for label, (proc, out, err) in workers.items():
        rc = proc.wait()
        out.seek(0)
        err.seek(0)
        text = out.read()
        if rc != 0:
            raise RuntimeError(f"session process {label}: exit code {rc}\n"
                               f"{text[-2000:]}\n{err.read()[-6000:]}")
        results[label] = json.loads(text.strip().splitlines()[-1])
    print(f"session processes: joined after {time.perf_counter() - t0:.1f} s of waiting")
    return results


def stop_session_processes(workers):
    for proc, _, _ in workers.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def check_session_processes(results, session, objects):
    """Each f64 plain session's ATE within 10% of its f32 kernel run's, and
    the plain runs launched no kernel; the second session observed a map
    object again, through K1 and K2."""
    for label, f32 in (("session", session), ("objects", objects)):
        r = results[label]
        mini = (", mini-BAs %d with %d LM iterations" % tuple(r["mini_ba"])
                if r["mini_ba"][0] else "")
        print(f"{label} f64 plain (session process): ATE {r['ate']:.6f} m, "
              f"{r['objects']} objects, {r['solves']} solves, {r['iterations']} LM iterations"
              f"{mini}, online portion {r['online_s']:.4f} s, final {r['final_s']:.4f} s")
        if not abs(r["ate"] - f32["ate"]) <= 0.1 * f32["ate"]:
            raise AssertionError(f"{label} ATE f32 {f32['ate']:.6f} vs f64 plain "
                                 f"{r['ate']:.6f}: past 10%")
        if any(r["launches"].values()):
            raise AssertionError(f"the plain {label} run launched kernels: {r['launches']}")
    r = results["second"]
    print(f"objects second session (session process, the main entry point on "
          f"{OBJECTS_SECOND['n_frames']} frames, seeded with the {len(objects['ltm_objects'])} "
          f"map objects): ATE {r['ate']:.6f} m, {r['objects']} objects, {r['merged']} merged, "
          f"map objects observed again (in its bb_assoc.json) {r['again']}; online "
          f"{r['online_s']:.4f} s, {r['iterations']} LM iterations, launches {r['launches']}")
    if not r["again"]:
        raise AssertionError("objects: the second session re-associated no map object")
    if not all(r["launches"][k] for k in OBJECTS_KERNELS):
        raise AssertionError(f"objects second session launches {r['launches']}")


def main():
    t_start = time.perf_counter()
    preconditions()
    tmp = tempfile.TemporaryDirectory()
    workers = {}
    try:
        exported = export_object_sessions(tmp.name)
        workers["session"] = start_session_process("session")
        workers["objects"] = start_session_process("objects", str(exported["objects"][0]))
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
        print(f"[{time.perf_counter() - t_start:.1f} s] checks done")
        phases = {label: main_path_phase(label) for label in PHASES}
        fixed_iterations("global")
        fixed_iterations("scale_1024", n_iters=10)
        print(f"[{time.perf_counter() - t_start:.1f} s] synthetic phases done")
        session = session_phase()
        errs["syrk"] = max(errs["syrk"], check_session_gram(session["syrk_operand"]))
        errs["reproj"] = max(errs["reproj"], check_session_reproj(*session["reproj_operands"]))
        print(f"[{time.perf_counter() - t_start:.1f} s] session phase done")
        objects = objects_phase(tmp.name, exported["objects"])
        workers["second"] = start_session_process(
            "second", str(exported["second"][0]), objects["ltm_path"],
            str(Path(tmp.name) / "second_out"))
        print(f"[{time.perf_counter() - t_start:.1f} s] objects phase done")
        bbox_err, reproj_err = check_object_tables(
            objects["window"], objects["mini"], objects["mini_reproj"])
        errs["bbox"] = max(errs["bbox"], bbox_err)
        errs["reproj"] = max(errs["reproj"], reproj_err)
        rows = time_kernels(errs, phases, gram_ops, session, objects)
        print(f"[{time.perf_counter() - t_start:.1f} s] kernel timings done")
        for label, ph in phases.items():
            profile_phase(label, ph)
        profile_session(session["run"])
        profile_objects(objects["run"])
        print(f"[{time.perf_counter() - t_start:.1f} s] profiles done")
        check_session_processes(join_session_processes(workers), session, objects)
    finally:
        stop_session_processes(workers)
        tmp.cleanup()
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
    if len(sys.argv) >= 3 and sys.argv[1] == SESSION_PROCESS_ARG:
        session_process(*sys.argv[2:])
    else:
        main()
