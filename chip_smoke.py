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
synthetic problems, the f64 band-solve step against the f64 dense step
at 1,024 poses (cyclic reduction) and at 256 poses with the gate forced on
(the sequential tile loop), and one f64 step of the 1,024-pose problem
relabelled out and back (``out_and_back``: a loop closure, solved by pair
enumeration) against its banded step mapped back through the permutation.
Then it drives the main path, eight phases, each with the launch counts
(and the Schur path counts, ``schur.path_counts``) reset just before it:

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
  - ``loop_768``: the two-phase global bundle adjustment of 768 poses x
    16384 points x 64 objects relabelled out and back (the robot drives the
    line out and back over the same ground, so most points are seen from
    poses up to 767 apart): the banded layout refuses it, the point slot
    grid is over budget, so every step builds the dense U from the pairs and
    its gram, and the object slot gram; K1 and K2, no K3, no band solve;
  - ``loop_1024``: ``scale_1024``'s problem relabelled out and back: U is
    over 256M elements, so every step enumerates pairs (one accumulating
    scatter into S, a 6144^2 Cholesky); K1 and K2; also a fixed
    10-iteration solve;

each checked against an f64 run of the plain versions (phase 2 with the f32
run's outlier selection) and against an f64 run that selects its own,
whose selection may differ in at most 5% of the excluded factors. These
phases time the host LM loop (``solve_two_phase``); the final-cost gates
(1e-3) compare an f32 solve and its references made under deterministic
algorithms (``deterministic``), because where the LM stops on a slow
descent moves with the order of the card's atomic sums. The ``fused`` phase
then runs each of the five problems through ``solve_two_phase_fused``,
the path the runner takes on the card: each LM iteration a replay of a
CUDA graph captured over static buffers, the running flag read once per
chunk of ``lm_fused.CHUNK`` iterations. In f64 under deterministic
algorithms the graph path must end as the eager host loop does (the same
termination, iteration counts within 1, final states within 1e-9), both
where it builds its graphs and where it replays them; in f32 through the
kernels it meets the synthetic phases' gates (every kernel launched,
counted per replay from its capture; the Schur paths of every step; the
final costs within 1e-3 of the f64 plain run with its factor selection,
both deterministic).
It prints LM it/s both ways, the host's launches per LM iteration (eager:
every device operation; graph path: graph replays), the busy share, the
captures and ms per capture, and fixed 20-iteration rates at 1 and 4
iterations per flag read. The sessions below run on the graph path, the
runner's default on the card, and print their captures; and

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
    empty reprojection table. Both sessions presize their capacities (the
    runner's caps pools from the raw data before frame 0, the mini-BA's
    bucketed caps), and print their graph entries and captures by solve
    family (``GraphFamilies``); one mini-BA on asymmetric chairs, in f64
    under deterministic algorithms, at the buckets must end within 1e-9 of
    the same mini-BA at the pending set's own sizes
    (``mini_ba_padding_check``). The Jacobian debug oracle then reads the
    session's final checkpoint: ``extract_jacobian`` in f64 through K1/K2
    against the CPU's plain run, and the ``debug_jacobian_hessian_diagonal``
    CLI with ``--device cuda`` against ``--device cpu``.

The sharded phase runs global BA over four gloo rank processes that
share the one card (``chip_smoke.py --sharded-rank r 4 port dir``, started
after the build, joined after the synthetic phases): ``scale_1024`` on 4 and on 2
ranks (the band solve domain-decomposed, one domain per rank), ``window``
on 2 (K4 on each rank's landmark rows) and ``loop_1024`` on 2 (pair
enumeration), each the f64 plain step against one process (1e-9), the f32
two-phase solve through the kernels against the f64 plain one on the ranks
(1e-3, both deterministic), ranks equal bit for bit, every kernel launched
on every rank and held against its plain version on the rank's operands, the
domain-decomposed step's all-gather budget; it prints the collectives and
ms per LM iteration (ranks sharing one card: correctness and traffic, not
scaling).

Then the rest of the package, on the object session's results:

  - ``visualize``: the debug images' overlays (predicted boxes, feature
    reprojections) of every frame of the final pose graph and frontend,
    computed on the card and on the CPU in f64, equal counts and values
    within 1e-9; ms per frame; the PNGs only where PIL is installed;
  - ``tools``: the sparsifier, interpolator, trajectory length, re-keying
    by timestamp, sequence and approach metrics (each ATE equal to the
    in-memory aligned ATE within 1e-9 m), timing analysis and LTM dump, in
    process on the session's files, each read back (the plots only where
    matplotlib is installed); host seconds of each;
  - ``pipeline``: ``single_trajectory_estimator --sparsify --device cuda``
    on a 32-frame visual session, a process of its own started after the
    sharded phase: the port's sparsifier, then its main entry point on the
    card; ATE below half the odometry's, every output read back;
  - ``frontend_ranks``: a 12-frame object session with four chairs through
    the main entry point's ``build_session`` with ``--shard_devices 2``, two
    gloo rank processes on the card (``chip_smoke.py --frontend-rank r 2
    port dir``): pose graphs, long-term maps (extracted on each rank with
    deterministic algorithms), pending estimates and solve logs equal bit
    for bit, at least three chairs, K1 and K2 launched on each rank; it
    prints the frontend's broadcasts and how far rank 1's estimates were
    from rank 0's before them;
  - ``flops``: the reference's FLOP model of one LM iteration
    (``flops.lm_iteration_flops``) of ``global``, ``window`` and
    ``scale_1024`` beside their profiled device ms per LM iteration.

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
poses, the dense U gram's at loop_768, the S scatter's and the Cholesky's
at loop_1024) and of both sessions' last 8 frames (the object session's run on
from a copy of its state taken before them), one JSON line describing the
kernels, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. There is no CPU path.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# cuBLAS is deterministic only with this workspace setting, which must be in
# place before its first use (fused_phase runs deterministic algorithms).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import obvi_slam_tpu_torch as ot  # noqa: E402
from obvi_slam_tpu_torch import factors as fac  # noqa: E402
from obvi_slam_tpu_torch import parallel as par  # noqa: E402
from obvi_slam_tpu_torch import ops  # noqa: E402
from obvi_slam_tpu_torch.ops import _build, band_gram, syrk  # noqa: E402
from obvi_slam_tpu_torch.ops import bbox as k_bbox  # noqa: E402
from obvi_slam_tpu_torch.ops import reproj as k_reproj  # noqa: E402
from obvi_slam_tpu_torch.ops._gram import lower_pair  # noqa: E402
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main  # noqa: E402
from obvi_slam_tpu_torch.timing import TimerRegistry  # noqa: E402
from obvi_slam_tpu_torch.runner import visual_frontend_for  # noqa: E402
from obvi_slam_tpu_torch.solver import band_solve  # noqa: E402
from obvi_slam_tpu_torch.solver.plan import build_schur_plan  # noqa: E402
from obvi_slam_tpu_torch.solver import schur as schur_mod  # noqa: E402
from obvi_slam_tpu_torch.solver import two_phase as tp_mod  # noqa: E402
from obvi_slam_tpu_torch.solver import (  # noqa: E402
    TERMINATION_NAMES,
    LMParams,
    TwoPhaseAux,
    TwoPhaseConfig,
    solve,
    solve_fused,
    solve_two_phase,
    solve_two_phase_fused,
)
from obvi_slam_tpu_torch.solver import lm_fused  # noqa: E402

WINDOW = dict(n_poses=64, n_points=4096, n_objects=32, obs_per_point=6, obs_per_object=12, seed=0)
GLOBAL = dict(WINDOW, n_poses=256)
SCALE = dict(n_poses=1024, n_points=16384, n_objects=64, obs_per_point=6, obs_per_object=12,
             seed=0)
LOOP_768 = dict(SCALE, n_poses=768)
# Synthetic phases of the main path and the kernels each must launch.
PHASES = {
    "global": (GLOBAL, ("reproj", "bbox", "band_gram")),
    "window": (WINDOW, ("reproj", "bbox", "syrk")),
    "scale_1024": (SCALE, ("reproj", "bbox", "band_gram")),
    "loop_768": (LOOP_768, ("reproj", "bbox")),
    "loop_1024": (SCALE, ("reproj", "bbox")),
}
# Loop-closure phases: their problem relabelled out and back
# (``out_and_back``), and the Schur paths (``schur.path_counts``) every step
# of theirs must take: at 768 poses the point slot grid (16384 x 6 x 768) is
# over budget, so the dense U from the pairs and its gram, the object slot
# gram; at 1,024 poses U (6144 x 49152) is over 256M elements, so pair
# enumeration. Neither runs K3 or the band solve.
LOOP_PATHS = {"loop_768": ("pt_dense_from_pairs", "ob_slot"),
              "loop_1024": ("pair_enumeration",)}
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
# The pending set of the mini-BA padding check: four chairs of asymmetric
# dimensions over four frames of one camera (fewer views than the
# association's 5, so that they stay pending), and the largest difference
# of the padded mini-BA's estimates from the unpadded one's, f64, as a share
# of their scale.
MINI_BA_SET = dict(n_frames=4, n_objects=4, n_features=80, seed=21, dims=(0.5, 0.8, 0.975))
MINI_BA_PAD_TOL = 1e-9
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


def out_and_back(prob):
    """The problem relabelled out and back: the robot drives the line out on
    the old even poses and back over the same ground on the old odd ones
    (new pose k < P/2 is old pose 2k, k >= P/2 is old 2(P-1-k)+1; pose 0
    stays the fixed gauge). Each table's pose indices, the poses and the free
    mask are permuted and the Schur plan is rebuilt by the port's plan
    builder; the problem is the same. Most landmarks are then seen from both
    legs, up to P - 1 poses apart: a loop closure, which the banded layout
    refuses. Returns (problem, old pose of each new pose)."""
    state0, state_gt, cams, tables, _, free, weights, huber = prob
    n_pose = state0.poses.shape[0]
    k = np.arange(n_pose)
    old_of_new = np.where(k < n_pose // 2, 2 * k, 2 * (n_pose - 1 - k) + 1)
    device = state0.poses.device
    new_of_old = torch.from_numpy(np.argsort(old_of_new).astype(np.int32)).to(device)
    order = torch.from_numpy(old_of_new).to(device)

    def idx(x):
        return new_of_old[x.long()]

    def poses(s):
        return s._replace(poses=s.poses[order])

    pp = tables.param_prior
    tables = tables._replace(
        reproj=tables.reproj._replace(pose_idx=idx(tables.reproj.pose_idx)),
        bbox=tables.bbox._replace(pose_idx=idx(tables.bbox.pose_idx)),
        relpose=tables.relpose._replace(before_idx=idx(tables.relpose.before_idx),
                                        after_idx=idx(tables.relpose.after_idx)),
        param_prior=pp._replace(block_idx=torch.where(
            pp.block_kind == 0, idx(pp.block_idx.clamp(0, n_pose - 1)), pp.block_idx)),
    )
    rl = tables.relpose
    live = rl.mask.cpu().numpy()
    plan = build_schur_plan(
        tables, n_pose=n_pose, rl_before=rl.before_idx.cpu().numpy()[live],
        rl_after=rl.after_idx.cpu().numpy()[live], rl_cap=rl.capacity, device=device,
    )
    free = free._replace(poses=free.poses[order])
    return (poses(state0), poses(state_gt), cams, tables, plan, free, weights, huber), old_of_new


def phase_problem(label, dtype):
    """The synthetic problem of phase ``label``, relabelled out and back for
    a loop-closure phase."""
    prob = problem(dtype, PHASES[label][0])
    return out_and_back(prob)[0] if label in LOOP_PATHS else prob


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
    for label in PHASES:
        state, _, cams, tables, *_ = phase_problem(label, np_dtype)
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
    steps = {}
    schur_mod.reset_path_counts()
    for dtype, plain in ((np.float64, True), (np.float32, False)):
        state, _, cams, tables, plan, free, weights, huber = phase_problem(label, dtype)
        steps[dtype] = ot.compute_step(
            state, cams, tables, plan, free, weights, 1e4, huber, plain=plain
        )
    torch.cuda.synchronize()
    paths = dict(schur_mod.path_counts)
    (d64, mc64, _), (d32, mc32, _) = steps[np.float64], steps[np.float32]
    errs = {
        "poses": rel(d32.poses, d64.poses),
        "points": rel(d32.points, d64.points),
        "objects": rel(d32.objects, d64.objects),
        "model_cost_change": abs(float(mc32) - float(mc64)) / abs(float(mc64)),
    }
    print(
        f"{label} step (paths {paths}) f32 (kernels) vs f64 (plain): "
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


def check_relabelled_step():
    """Equal work, relabelled: one f64 plain step on loop_1024 (pair
    enumeration) against one on scale_1024 (banded layout, band solve),
    mapped back through the permutation; deltas and model cost change
    within relative 1e-9."""
    prob = problem(np.float64, PHASES["loop_1024"][0])
    loop, old_of_new = out_and_back(prob)
    schur_mod.reset_path_counts()
    band = ot.compute_step(*prob[:1], *prob[2:7], 1e4, prob[7], plain=True)
    band_paths = dict(schur_mod.path_counts)
    schur_mod.reset_path_counts()
    pair = ot.compute_step(*loop[:1], *loop[2:7], 1e4, loop[7], plain=True)
    pair_paths = dict(schur_mod.path_counts)
    torch.cuda.synchronize()
    if "band_solve" not in band_paths or "pair_enumeration" not in pair_paths:
        raise AssertionError(f"relabelled step: paths {band_paths} and {pair_paths}")
    back = torch.empty_like(pair[0].poses)
    back[torch.from_numpy(old_of_new).to(back.device)] = pair[0].poses
    errs = {"poses": rel(back, band[0].poses), "points": rel(pair[0].points, band[0].points),
            "objects": rel(pair[0].objects, band[0].objects),
            "model_cost_change": abs(float(pair[1]) - float(band[1])) / abs(float(band[1]))}
    print("loop_1024 step f64 plain (pair enumeration), mapped back, vs scale_1024 step "
          "(banded, band solve): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        if not v <= 1e-9:
            raise AssertionError(f"relabelled step {k} relative error {v:.3e} > 1e-9")


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


def run_two_phase(problem, plain, fused=False):
    """One two-phase solve of ``problem`` with the default parameters: the
    host LM loop (``solve_two_phase``), or with ``fused`` the captured solve
    (``solve_two_phase_fused``, CUDA graphs). Returns (final state, summary
    1, summary 2, wall s)."""
    state, _, cams, tables, plan, free, weights, huber = problem
    aux = TwoPhaseAux(
        is_ltm_obj=torch.zeros(state.objects.shape[0], dtype=torch.bool, device=state.objects.device),
        shape_live=tables.shape.mask,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, s1, s2 = (solve_two_phase_fused if fused else solve_two_phase)(
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


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms, cuSOLVER for the linear algebra, for the
    block: sums in a fixed order, so that a run repeats bit for bit on one
    card. The LM's stopping point on a slow descent moves with the order of
    the atomic sums (``lm_stop_spread.py``), so the final-cost gates
    compare runs made so."""
    linalg = torch.backends.cuda.preferred_linalg_library()
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cuda.preferred_linalg_library(linalg)


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
    of the launch counts; then, under deterministic(), the solve once more
    and the f64 plain reference."""
    _, expected = PHASES[label]
    problem32 = phase_problem(label, np.float32)
    run_two_phase(problem32, plain=False)  # warm-up: allocator, cuBLAS/cuSOLVER handles

    torch.cuda.reset_peak_memory_stats()
    with BandSolveSpy() as spy:
        ops.reset_kernel_launches()
        schur_mod.reset_path_counts()
        final, s1, s2, wall = run_two_phase(problem32, plain=False)
        launches = ops.kernel_launches()
        paths = dict(schur_mod.path_counts)
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
          f"({spy.calls / iters:.2f} per LM iteration); Schur paths {paths}")
    if paths.get("steps") != iters:
        raise AssertionError(f"{label}: {paths.get('steps')} steps counted, {iters} LM iterations")
    for name in LOOP_PATHS.get(label, ()):
        if paths.get(name) != iters:
            raise AssertionError(f"{label}: {paths.get(name, 0)} of {iters} steps took {name}")
    if label in LOOP_PATHS and (launches["band_gram"] or paths.get("band_solve")):
        raise AssertionError(f"{label}: K3 launched or band solve taken on a loop closure")

    # The final-cost gates: the f32 solve through the kernels once more and
    # its reference, both under deterministic() so that the gaps repeat
    # from run to run. The reference: both phases in f64 through the plain
    # versions, phase 2 with the f32 run's factor selection. Two runs that
    # select their own outliers at slightly different phase-1 optima can
    # exclude different factors at the 10% boundary, and then solve
    # different phase-2 problems. The independent reference: an f64 plain
    # solve_two_phase that selects its own outliers. Its selection may
    # differ from the f32 run's in at most SELECTION_LIMIT of the factors
    # the f32 run excluded; where the two agree, its phase-2 final cost must
    # lie within 1e-3 as well.
    with deterministic():
        with Spy(tp_mod, "reweight_on_device") as selection:
            final, d1, d2, _ = run_two_phase(problem32, plain=False)
        weights2 = schur_mod.FactorWeights(*(w.double() for w in selection.result))
        final64, r1, r2, wall64 = reference_two_phase(phase_problem(label, np.float64),
                                                      weights2)
        with Spy(tp_mod, "reweight_on_device") as own:
            _, _, own2, _ = run_two_phase(phase_problem(label, np.float64), plain=True)
    check_result(final, (d1, d2), f"{label} f32 kernels (deterministic)")
    excluded = int(((problem32[3].reproj.mask) & (weights2.reproj == 0)).sum())
    check_result(final64, (r1, r2), f"{label} f64 plain (deterministic)")
    print(f"{label} f64 plain: {wall64:.4f} s wall; phase 2 with the f32 run's selection "
          f"({excluded} reprojection factors excluded)")
    for k, (a, b) in enumerate(((d1, r1), (d2, r2)), 1):
        gap = abs(a.final_cost - b.final_cost) / b.final_cost
        print(f"{label} phase {k} final cost f32 kernels vs f64 plain: relative gap {gap:.3e}")
        if not gap <= 1e-3:
            raise AssertionError(f"{label} phase {k} final cost gap {gap:.3e} > 1e-3")
    changed = sum(int((a != b).sum()) for a, b in zip(own.result, weights2))
    own_gap = abs(d2.final_cost - own2.final_cost) / own2.final_cost
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
                band_operands=spy.operands, paths=paths, peak=peak)


def fixed_iterations(label, n_iters=20, runs=3):
    """LM iterations/s over fixed-length solves (tolerances at 0), so that
    the rate does not ride on the run-to-run iteration count; the median of
    ``runs`` solves, each from the same start."""
    state, _, cams, tables, plan, free, weights, huber = phase_problem(label, np.float32)
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


# ---- the fused solves: CUDA graphs --------------------------------------------

# Iterations per read of the running flag (lm_fused.CHUNK) compared on
# fixed-length solves, in the phases where the host's share is largest.
FUSED_CHUNKS = (1, 4)
FUSED_CHUNK_PHASES = ("global", "window")
FUSED_FIXED_ITERATIONS = 20
# Graph path against the eager host loop, f64 under deterministic
# algorithms: iteration counts per phase at most this far apart, final
# states within FUSED_RTOL.
FUSED_ITERATION_SLACK = 1
FUSED_RTOL = 1e-9


def device_profile(fn):
    """``fn()`` under torch.profiler, CUDA activity only (a window with CPU
    activity left the later windows of the process short of kernel
    records): (its result, device operations, device busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    ops_ = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (out, sum(e.count for e in ops_),
            sum(e.self_device_time_total for e in ops_) / 1e3)


def _fixed_params(n_iters):
    return LMParams(max_num_iterations=n_iters, function_tolerance=0.0, gradient_tolerance=0.0,
                    parameter_tolerance=0.0)


def eager_launches_per_iteration(problem):
    """Device operations of one host-loop LM iteration, each one launched by
    the host: the difference of 4- and 2-iteration solves, over 2."""
    state, _, cams, tables, plan, free, weights, huber = problem
    counts = []
    for n in (2, 4):
        _, n_ops, _ = device_profile(lambda: solve(state, cams, tables, plan, free, weights,
                                                   _fixed_params(n), huber))
        counts.append(n_ops)
    return (counts[1] - counts[0]) / 2


def _same_solve(label, what, run, ref):
    """Gate: ``run`` against ``ref`` (two run_two_phase results): the same
    termination per phase, iteration counts within FUSED_ITERATION_SLACK,
    final states within FUSED_RTOL. Returns the largest relative gap."""
    for k, (a, b) in enumerate(zip(run[1:3], ref[1:3]), 1):
        if a.termination != b.termination or abs(
                a.num_iterations - b.num_iterations) > FUSED_ITERATION_SLACK:
            raise AssertionError(
                f"{label} {what} phase {k}: {a.num_iterations} iterations, {a.termination}; "
                f"the eager host loop {b.num_iterations}, {b.termination}")
    gap = max(rel(getattr(run[0], n), getattr(ref[0], n)) for n in ("poses", "points", "objects"))
    if not gap <= FUSED_RTOL:
        raise AssertionError(f"{label} {what}: final state {gap:.3e} from the eager host loop's")
    return gap


def fused_phase(label, phase):
    """The captured two-phase solve (``solve_two_phase_fused``: CUDA graphs
    replayed, the running flag read once per chunk) on the phase's problem.
    In f64 under deterministic algorithms (cuSOLVER for both) against the
    eager host loop: the solve that builds the graphs and one that replays
    them (``_same_solve``). In f32 through the kernels, between a reset and
    a read of the counts: every kernel of the phase launched (replays add
    their capture's launches), the Schur paths of every step; then, both
    under deterministic(), the final costs of the f32 graph path within
    1e-3 of an f64 plain run (graph path; phase 2 with the f32 run's factor
    selection). Then LM it/s of a replaying solve against the host loop's
    (``phase``, main_path_phase), the host's launches per LM
    iteration both ways (eager: the device operations of an iteration;
    graph path: graph replays), the graph path's device operations and busy
    share (torch.profiler), captures and ms per capture; in
    FUSED_CHUNK_PHASES fixed-length rates at each of FUSED_CHUNKS."""
    t0 = time.perf_counter()
    card = card_line()
    prob64 = phase_problem(label, np.float64)
    lm_fused.clear_graphs()
    try:
        with deterministic():
            host = run_two_phase(prob64, plain=False)
            built = run_two_phase(prob64, plain=False, fused=True)
            replayed = run_two_phase(prob64, plain=False, fused=True)
    finally:
        lm_fused.clear_graphs()
    gaps = [_same_solve(label, what, run, host)
            for what, run in (("f64 graphs (built)", built), ("f64 graphs (replayed)", replayed))]
    print(f"{label} f64 deterministic: graph path {built[1].num_iterations} + "
          f"{built[2].num_iterations} iterations, {built[2].termination}; eager host loop "
          f"{host[1].num_iterations} + {host[2].num_iterations}, {host[2].termination}; final "
          f"states {gaps[0]:.3e} (built) and {gaps[1]:.3e} (replayed) apart; host loop "
          f"{host[3]:.3f} s, graphs {built[3]:.3f} s and {replayed[3]:.3f} s "
          f"[{time.perf_counter() - t0:.1f} s]")

    _, expected = PHASES[label]
    prob32 = phase_problem(label, np.float32)
    lm_fused.reset_graph_stats()
    ops.reset_kernel_launches()
    schur_mod.reset_path_counts()
    final, s1, s2, _ = run_two_phase(prob32, plain=False, fused=True)
    launches = ops.kernel_launches()
    paths = dict(schur_mod.path_counts)
    check_result(final, (s1, s2), f"{label} f32 graphs")
    iters = s1.num_iterations + s2.num_iterations
    steps = paths.get("steps", 0)
    if not iters <= steps <= iters + 2 * (lm_fused.CHUNK - 1):
        raise AssertionError(f"{label} graphs: {steps} steps counted for {iters} LM iterations")
    for name in expected:
        if launches[name] != steps:
            raise AssertionError(f"{label} graphs: kernel {name} launched {launches[name]} "
                                 f"times in {steps} steps")
    for name in LOOP_PATHS.get(label, ()) + (("band_solve",) if label == BAND_SOLVE_PHASE
                                             else ()):
        if paths.get(name) != steps:
            raise AssertionError(f"{label} graphs: {paths.get(name, 0)} of {steps} steps "
                                 f"took {name}")
    if label != BAND_SOLVE_PHASE and paths.get("band_solve"):
        raise AssertionError(f"{label} graphs: band solve taken")
    if label in LOOP_PATHS and launches["band_gram"]:
        raise AssertionError(f"{label} graphs: K3 launched on a loop closure")
    state, _, cams, tables, plan, free, weights, huber = prob64
    with deterministic():
        with Spy(tp_mod, "reweight_on_device") as selection:
            final, d1, d2, _ = run_two_phase(prob32, plain=False, fused=True)
        weights2 = schur_mod.FactorWeights(*(w.double() for w in selection.result))
        r1 = solve_fused(state, cams, tables, plan, free, weights, LMParams(), huber,
                         plain=True)[1]
        r2 = solve_fused(state, cams, tables, plan, free, weights2, LMParams(), huber,
                         plain=True)[1]
    check_result(final, (d1, d2), f"{label} f32 graphs (deterministic)")
    cost_gaps = [abs(a.final_cost - b.final_cost) / b.final_cost
                 for a, b in ((d1, r1), (d2, r2))]
    if not max(cost_gaps) <= 1e-3:
        raise AssertionError(f"{label} graphs: final cost gaps {cost_gaps} to the f64 plain "
                             "run > 1e-3")

    run_two_phase(prob32, plain=False, fused=True)  # captures the start and the switch
    before = dict(lm_fused.graph_stats)
    _, t1, t2, wall = run_two_phase(prob32, plain=False, fused=True)
    t_iters = t1.num_iterations + t2.num_iterations
    replays = lm_fused.graph_stats["replays"] - before["replays"]
    if lm_fused.graph_stats["captures"] != before["captures"]:
        raise AssertionError(f"{label} graphs: the timed solve captured")
    (_, p1, p2, _), graph_ops, busy_ms = device_profile(
        lambda: run_two_phase(prob32, plain=False, fused=True))
    p_iters = p1.num_iterations + p2.num_iterations
    eager_launches = eager_launches_per_iteration(prob32)
    stats = lm_fused.graph_stats
    capture_ms = stats["capture_s"] * 1e3 / max(stats["captures"], 1)
    host_rate = phase["iters"] / phase["wall"]
    busy = (f"{busy_ms / p_iters / (wall * 1e3 / t_iters):.4f}" if busy_ms > 0
            else "not measured (the profiler saw no device time)")
    print(f"{label} f32 graphs on {card}: {t_iters} LM iterations in {wall:.4f} s, "
          f"{t_iters / wall:.2f} LM it/s (host loop {host_rate:.2f}, x{t_iters / wall / host_rate:.2f}"
          f"); host launches per LM iteration: eager {eager_launches:.1f} device operations, "
          f"graph path {replays / t_iters:.3f} graph replays ({graph_ops / p_iters:.1f} device "
          f"operations); busy share {busy}; {stats['captures']} captures, {capture_ms:.2f} ms "
          f"per capture; final cost gaps to f64 plain {cost_gaps[0]:.3e}, {cost_gaps[1]:.3e}; "
          f"launches {launches}; paths {paths} [{time.perf_counter() - t0:.1f} s]")

    rates = {}
    if label in FUSED_CHUNK_PHASES:
        state, _, cams, tables, plan, free, weights, huber = prob32
        params = _fixed_params(FUSED_FIXED_ITERATIONS)
        default = lm_fused.CHUNK
        try:
            for chunk in FUSED_CHUNKS:
                lm_fused.CHUNK = chunk
                runs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t1_ = time.perf_counter()
                    solve_fused(state, cams, tables, plan, free, weights, params, huber)
                    torch.cuda.synchronize()
                    runs.append(FUSED_FIXED_ITERATIONS / (time.perf_counter() - t1_))
                rates[chunk] = statistics.median(runs[1:])  # the first may build graphs
        finally:
            lm_fused.CHUNK = default
        print(f"{label} fixed {FUSED_FIXED_ITERATIONS}-iteration f32 graph solves on {card}: "
              + ", ".join(f"{rates[k]:.2f} LM it/s with {k} per flag read"
                          for k in FUSED_CHUNKS))
    lm_fused.clear_graphs()
    return dict(iters=t_iters, wall=wall, rate=t_iters / wall, host_rate=host_rate,
                eager_launches=eager_launches, replays=replays / t_iters,
                busy_ms=busy_ms / p_iters if busy_ms > 0 else None, launches=launches,
                captures=stats["captures"], capture_ms=capture_ms, chunk_rates=rates)


# ---- the runner session ----------------------------------------------------


def capturing() -> bool:
    """True while a CUDA graph is being captured on the current stream: a
    spy then sees operands that hold no values yet."""
    return DEVICE == "cuda" and torch.cuda.is_current_stream_capturing()


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


class GraphFamilies:
    """While active, counts the fused solves' cache entries built and graphs
    captured by solve family: the caps pool of the problem the runner built
    last ("local", "global", "pgo", "pgo_vf", "pgo_tracking"), or "mini_ba"
    inside the bounding-box frontend's pending-object mini-BA ("other"
    before any build)."""

    def __enter__(self):
        from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf

        self.counts = {}
        family = [None]
        runner_cls, fe_cls = ot.OfflineProblemRunner, bbf.FeatureBasedBoundingBoxFrontEnd
        self.saved = [(runner_cls, "_build_problem", runner_cls._build_problem),
                      (fe_cls, "_run_pending_mini_ba", fe_cls._run_pending_mini_ba),
                      (lm_fused._Graphs, "_capture", lm_fused._Graphs._capture),
                      (lm_fused, "_entry", lm_fused._entry)]
        build, mini_ba, capture, entry = (fn for _, _, fn in self.saved)

        def tally(what):
            counts = self.counts.setdefault(family[0] or "other", dict(entries=0, captures=0))
            counts[what] += 1

        def build_problem(runner, pg, scope, key, **kw):
            family[0] = key
            return build(runner, pg, scope, key, **kw)

        def run_mini_ba(fe, targets):
            before, family[0] = family[0], "mini_ba"
            try:
                return mini_ba(fe, targets)
            finally:
                family[0] = before

        def capture_counted(graphs, fn):
            tally("captures")
            return capture(graphs, fn)

        def entry_counted(*a, **k):
            out = entry(*a, **k)
            if out[1]:
                tally("entries")
            return out

        for (owner, name, _), fn in zip(self.saved, (build_problem, run_mini_ba,
                                                      capture_counted, entry_counted)):
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


def graph_summary(what, families=None):
    """Prints and returns the fused solves' graph statistics since the last
    lm_fused.reset_graph_stats(), with a ``GraphFamilies`` count by solve
    family; fails unless graphs were replayed or if the families' counts do
    not add up to the totals."""
    stats = dict(lm_fused.graph_stats)
    if not stats["replays"]:
        raise AssertionError(f"{what}: no CUDA graph replayed (the fused path was not taken)")
    print(f"{what} graphs on {card_line()}: {stats['entries_built']} entries built, "
          f"{stats['captures']} captures in {stats['capture_s']:.4f} s "
          f"({stats['capture_s'] * 1e3 / max(stats['captures'], 1):.2f} ms each), "
          f"{stats['replays']} replays, {stats['flag_reads']} flag reads, {stats['evictions']} "
          f"evictions; {stats['entries']} entries of {stats['bytes']} B held")
    if families is not None:
        by = families.counts
        print(f"{what} graphs by solve family: " + "; ".join(
            f"{name} {c['entries']} entries, {c['captures']} captures"
            for name, c in sorted(by.items())))
        for key in ("entries", "captures"):
            total = stats["entries_built" if key == "entries" else key]
            if sum(c[key] for c in by.values()) != total:
                raise AssertionError(f"{what}: {key} by family {by} do not add up to {total}")
        stats["families"] = {name: dict(c) for name, c in by.items()}
    return stats


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
        if not capturing() and (not kept or c.shape[0] > kept[0].shape[0]):
            kept[:] = [c]
        return inner(c)

    # K1's operands at the largest reprojection table (a copy: the state
    # moves on).
    reproj_kept = []
    reproj_inner = ops.reproj_residuals_and_jac

    def reproj_spy(state, cams, f):
        if not capturing() and (not reproj_kept or f.capacity > reproj_kept[0][2].capacity):
            reproj_kept[:] = [tuple(type(x)(*(t.clone() for t in x)) for x in (state, cams, f))]
        return reproj_inner(state, cams, f)

    ops.syrk_gram, ops.reproj_residuals_and_jac = spy, reproj_spy
    torch.cuda.reset_peak_memory_stats()
    lm_fused.reset_graph_stats()
    try:
        with BandSolveSpy() as band, GraphFamilies() as families:
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
    graphs = graph_summary("session", families)
    if not (ate < 0.5 * odom and ate < 0.05):
        raise AssertionError(f"session ATE {ate:.6f} m: not below half the odometry's "
                             f"({odom:.6f} m) and 0.05 m")

    return dict(launches=launches, iters=iters, wall=online_s + run["final_s"],
                syrk_operand=kept[0], reproj_operands=reproj_kept[0],
                frames_per_s=len(online) / online_s, ate=ate, run=run, graphs=graphs)


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
    inner, inner_fused, two_phase = bbf.solve, bbf.solve_fused, runner._solve_two_phase

    def counting(solve):
        def counted(*a, **k):
            stage[0] = "mini-BA"
            try:
                out = solve(*a, **k)
            finally:
                stage[0] = None
            mini[0] += 1
            mini[1] += out[1].num_iterations
            return out
        return counted

    def window_ba(*a, **k):
        stage[0] = "window"
        try:
            return two_phase(*a, **k)
        finally:
            stage[0] = None
            windows[0] += 1

    bbf.solve, bbf.solve_fused = counting(inner), counting(inner_fused)
    runner._solve_two_phase = window_ba
    try:
        run = _drive(runner, data, pg, vf, data.max_frame_id() + 1,
                     before_frame=_snapshot_at(snapshot_at, snapshot, runner, pg, vf, fe))
    finally:
        bbf.solve, bbf.solve_fused = inner, inner_fused
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
        if keep is not None and not capturing() and (
                not keep or f.capacity > keep[0][2].capacity):
            keep[:] = [(*_copy_args(state, cams, f), invalid_error)]
        return bbox_inner(state, cams, f, invalid_error)

    def reproj_spy(state, cams, f):
        if stage[0] == "mini-BA" and not mini_reproj and not capturing():
            mini_reproj.append(_copy_args(state, cams, f))
        return reproj_inner(state, cams, f)

    n_frames = OBJECTS["n_frames"]
    ops.bbox_residuals_and_jac, ops.reproj_residuals_and_jac = bbox_spy, reproj_spy
    torch.cuda.reset_peak_memory_stats()
    lm_fused.reset_graph_stats()
    try:
        with GraphFamilies() as families:
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
    graphs = graph_summary("objects", families)
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
                ltm_objects=sorted(loaded.ellipsoids), graphs=graphs)


def mini_ba_padding_check():
    """One pending-object mini-BA on the card in f64 under deterministic
    algorithms, at the frontend's capacity buckets and at the pending set's
    own sizes (``_bucket`` patched to the identity, as before the buckets):
    the estimates within MINI_BA_PAD_TOL of their scale. The pending set
    (MINI_BA_SET, asymmetric chairs, whose yaw the boxes observe) is
    gathered by the frontend on ground-truth poses with its mini-BA off."""
    from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf

    data, gt, _ = ot.synthetic_object_session(**MINI_BA_SET)
    config = object_config()
    std = np.array(CHAIR_PRIOR[1])
    config.shape_dimension_priors = [ot.config.ShapeDimensionPrior(
        "chair", np.array(MINI_BA_SET["dims"]), np.diag(std ** 2))]
    assoc = config.feature_based_bb_association_params
    assoc.min_observations, assoc.min_observations_for_local_est = 5, 3
    assoc.min_overlapping_features_for_match = 3.0
    pg = ot.PoseGraph(data.cameras, ot.config.shape_prior_map(config))
    for i, pose in enumerate(gt):
        pg.add_frame(i, pose)
    fe = bbf.FeatureBasedBoundingBoxFrontEnd(
        pg, assoc, config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params,
        img_heights_and_widths={c: (480.0, 640.0) for c in data.cameras}, dtype=np.float64,
        device=DEVICE)
    fe._run_pending_mini_ba = lambda targets: None
    hook = ot.frontend.make_bb_frontend_hook(fe)
    for i in range(len(gt)):
        hook(data, pg, i)
    del fe._run_pending_mini_ba
    targets = [i for i, p in enumerate(fe.pending) if p.object_estimate is not None]
    if len(targets) < 2:
        raise AssertionError(f"mini-BA padding: {len(targets)} pending estimates")
    start = {i: fe.pending[i].object_estimate.copy() for i in targets}
    shapes, inner, bucket = [], bbf.solve_fused, bbf._bucket

    def spy(state, cams, tables, plan, free, **kw):
        shapes.append((state.poses.shape[0], state.objects.shape[0], tables.bbox.capacity))
        return inner(state, cams, tables, plan, free, **kw)

    runs = {"padded": copy.deepcopy(fe), "unpadded": copy.deepcopy(fe)}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    bbf.solve_fused = spy
    try:
        runs["padded"]._run_pending_mini_ba(targets)
        bbf._bucket = lambda n, minimum=16: max(n, 1)
        runs["unpadded"]._run_pending_mini_ba(targets)
    finally:
        bbf.solve_fused, bbf._bucket = inner, bucket
        torch.use_deterministic_algorithms(deterministic)
    est = {k: np.stack([fe_.pending[i].object_estimate for i in targets])
           for k, fe_ in runs.items()}
    err = float(np.abs(est["padded"] - est["unpadded"]).max() / max(1.0, np.abs(
        est["unpadded"]).max()))
    moved = float(max(np.abs(est["padded"][k] - start[i]).max() for k, i in enumerate(targets)))
    print(f"mini-BA padded against unpadded on {card_line()} (f64, deterministic): "
          f"{len(targets)} pending objects, (poses, objects, boxes) {shapes[0]} against "
          f"{shapes[1]}; estimates moved up to {moved:.3e}, apart by {err:.3e} of their "
          f"scale (limit {MINI_BA_PAD_TOL:g})")
    if len(shapes) != 2 or shapes[0] == shapes[1] or not (err <= MINI_BA_PAD_TOL) or (
            moved <= 1e-6):
        raise AssertionError(f"mini-BA padding: shapes {shapes}, difference {err}, moved {moved}")
    return err


def oracle_phase(tmp, exported):
    """The Jacobian debug oracle on the object session's final pose-graph
    checkpoint: ``extract_jacobian`` in f64 on the card (K1 and K2, one
    launch each) against the CPU's plain run (the same rows and columns,
    values within the f64 tolerance of ``_compare``); then the CLI with
    ``--device cuda`` against ``--device cpu``: the same printed counts."""
    import contextlib
    import io as _io

    from obvi_slam_tpu_torch.cli import debug_jacobian_hessian_diagonal as debug_cli
    from obvi_slam_tpu_torch.solver import jacobian_debug as jd

    directory = Path(exported[0])
    ckpt = Path(tmp) / "objects_out" / "checkpoints" / f"{CHECKPOINTS[-1]}.json"
    files = (str(ckpt), str(directory / "config.json"), str(directory / "intrinsics.csv"),
             str(directory / "extrinsics.csv"))
    runs = []  # (info, launches, seconds) on the card, then on the CPU
    for device in (DEVICE, "cpu"):
        prob = debug_cli.load_problem(*files, device=device)
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        info = jd.extract_jacobian(prob.state, prob.cams, prob.tables, prob.huber)
        runs.append((info, ops.kernel_launches(), time.perf_counter() - t0))
    (card, card_launches, card_s), (cpu, cpu_launches, cpu_s) = runs
    if card_launches["reproj"] != 1 or card_launches["bbox"] != 1 or any(
            cpu_launches.values()):
        raise AssertionError(f"oracle: kernel launches {card_launches}, CPU {cpu_launches}")
    if not (np.array_equal(card.rows, cpu.rows) and np.array_equal(card.cols, cpu.cols)
            and card.row_owner == cpu.row_owner and (card.n_rows, card.n_cols) == (
                cpu.n_rows, cpu.n_cols)):
        raise AssertionError("oracle: the card's triplets sit elsewhere than the CPU's")
    families = sorted({name for name, _ in card.row_owner})
    err = _compare("oracle Jacobian", (torch.from_numpy(card.vals),),
                   (torch.from_numpy(cpu.vals),), torch.float64)
    print(f"oracle extract_jacobian f64 on the {ckpt.stem} checkpoint: {card.n_rows} rows x "
          f"{card.n_cols} columns, {len(card.vals)} non-zeros ({', '.join(families)}); card "
          f"(K1/K2, {card_s:.4f} s) vs CPU plain ({cpu_s:.4f} s): max "
          f"abs err {err:.3e} - ok")
    printed = []
    for device in (DEVICE, "cpu"):
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = debug_cli.main(["--input_checkpoint_file", files[0], "--params_config_file",
                                 files[1], "--intrinsics_file", files[2],
                                 "--extrinsics_file", files[3], "--device", device])
        if rc != 0:
            raise AssertionError(f"oracle CLI --device {device}: exit {rc}")
        printed.append([x for x in out.getvalue().splitlines()
                        if not x.startswith("Hessian diag")])
    if printed[0] != printed[1] or len(printed[1]) < 3:
        raise AssertionError(f"oracle CLI counts differ: {printed}")
    print(f"oracle CLI --device {DEVICE}, the same counts as --device cpu: "
          + "; ".join(printed[1][:3]))


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


# Spin kernels launched at the head of a short profiler window. Once the
# process has captured CUDA graphs, a window drops its first kernel records
# (2 of 40 K3 records after 240 captures; in a whole run K3 and K4 read 0.3-0.6
# of their time); the spins take the loss, and a window that kept none of
# them is taken again.
PROFILE_PAD = 2000
PAD_KERNEL = "spin_kernel"


def _profile_calls(fn, calls):
    """The device operations of ``calls`` calls of ``fn`` in one
    torch.profiler window (CUDA activity) behind PROFILE_PAD spin kernels,
    the spins left out; [] when no window of three kept a spin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(100)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if any(PAD_KERNEL in e.key for e in events):
            return [e for e in events if PAD_KERNEL not in e.key]
    return []


def device_ms(fn, match=None, calls=20):
    """Device time per call from torch.profiler: the self time of the device
    kernels whose name contains ``match`` (all of them when None), summed
    over ``calls`` calls (in up to three profiler windows, until one sees
    device time). 0.0 when none does."""
    total_us = 0.0
    for _ in range(3):  # a profiler window on a busy host can lose its kernel records
        total_us = sum(e.self_device_time_total for e in _profile_calls(fn, calls)
                       if match is None or match in e.key)
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
    return sum(e.count for e in _profile_calls(fn, calls)) / calls


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
    at scale_1024 also the band solve's share of the device time; at
    loop_768 the share of the dense U's gram U U^T, at loop_1024 those of the
    pair path's S scatter and of S's Cholesky (each timed alone on the
    operands of the profiled solve's last step). Returns the device ms per
    LM iteration (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    problem32 = phase_problem(label, np.float32)
    largest = []  # the widest dense U of the solve (a loop-closure point gram)
    inner = schur_mod._dense_from_pairs

    def dense_spy(*args, **kw):
        u = inner(*args, **kw)
        if not largest or u.numel() > largest[0].numel():
            largest[:] = [u]
        return u

    schur_mod._dense_from_pairs = dense_spy
    try:
        with Spy(schur_mod, "_scatter_blocks") as scatter, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, s1, s2, prof_wall = run_two_phase(problem32, plain=False)
    finally:
        schur_mod._dense_from_pairs = inner
    iters = s1.num_iterations + s2.num_iterations
    busy_ms = profile_summary(label, prof, prof_wall, iters, "LM iteration")
    if busy_ms <= 0:
        return None
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
    # Timed with CUDA events over back-to-back calls: a profiler window over
    # a few calls of tens of ms can lose kernel records.
    shares = {}
    if label == "loop_768" and largest:
        u = largest[0]
        shares[f"dense U gram ({u.shape[0]} x {u.shape[1]}, U U^T)"] = time_ms(
            lambda: u @ u.T, inner=3, reps=5)
    if scatter.calls:
        s_full = scatter.result
        shares[f"S scatter ({scatter.operands[3].shape[0]} blocks onto {s_full.shape[0]}^2, "
               "index_put_ accumulate + symmetrize)"] = time_ms(
            lambda: schur_mod._scatter_blocks(*scatter.operands), inner=3, reps=5)
        shares[f"Cholesky of S ({s_full.shape[0]}^2, cholesky_ex)"] = time_ms(
            lambda: torch.linalg.cholesky_ex(s_full), inner=3, reps=5)
    for what, ms in shares.items():
        print(f"profile {label}: {what} {ms:.3f} ms per call (CUDA events), one call per LM "
              f"iteration: {ms / (busy_ms / iters):.4f} of the device time per LM iteration")
    return busy_ms / iters


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



# ---- the sharded path: global BA over gloo ranks sharing the card ---------

SHARDED_RANK_ARG = "--sharded-rank"
# (phase, ranks) of the sharded phase, in order: the synthetic phases'
# problems sharded on the factor axis (parallel.shard_problem) over gloo
# ranks that share the one card: scale_1024's band solve domain-decomposed
# at h = 4 (4 tiles per domain) and h = 2 (8), the window's dense slot gram
# through K4 on each rank's landmark rows (the runner's shard_local_ba), and
# loop_1024's pair enumeration. The 2-rank runs take ranks 0 and 1.
SHARDED = (("scale_1024", 4), ("scale_1024", 2), ("window", 2), ("loop_1024", 2))
SHARDED_RANKS = 4
SHARDED_PATHS = {"scale_1024": "band_solve", "window": "pt_slot",
                 "loop_1024": "pair_enumeration"}
# The domain-decomposed step's all-gather budget (the reference's,
# tests/test_sharding_collectives.py): no f32 operand above (h, 384, 512),
# under 20 MB in all.
DD_GATHER_BYTES = 20e6
SHARDED_TIMEOUT_S = 900
WRAPPER_NAMES = {"reproj": "reproj_residuals_and_jac", "bbox": "bbox_residuals_and_jac",
                 "band_gram": "band_zbuild_gram", "syrk": "syrk_gram"}


def _shard(prob, mesh):
    """(state, cams, tables, plan, free, weights, huber): the rank's shard."""
    state, _, cams, tables, plan, free, weights, huber = prob
    return (state, cams, par.shard_tables(tables, mesh), par.shard_plan(plan, mesh), free,
            par.shard_weights(weights, mesh), huber)


def _per_iteration(by_op, iters):
    return {op: dict(count=v["count"] / iters, bytes=v["bytes"] / iters)
            for op, v in by_op.items()}


def check_kernels_on_shard(spies, tag):
    """Each kernel the solve launched, on the last operands this rank handed
    it, against its plain version (K1/K2 in f32 by the object tables' per-row
    rule, ``_compare_f32_rounding``: near the optimum f32 rounds the
    residuals themselves). Returns {kernel: max abs error}."""
    errs = {}
    for name, spy in spies.items():
        args = spy.operands
        if name in ("reproj", "bbox"):
            wrapper, plain = _factor_fns(name)
            out_k, out_p = wrapper(*args), plain(*args)
            torch.cuda.synchronize()
            if out_p[0].dtype == torch.float32:
                exact = plain(*(_cast(x, torch.float64) for x in args[:3]), *args[3:])
                errs[name] = _compare_f32_rounding(f"{name} {tag}", out_k, out_p, exact,
                                                   args[2].mask)["err"]
                continue
            live = args[2].mask
        else:
            wrapper = getattr(ops, WRAPPER_NAMES[name])
            out_k, out_p, live = wrapper(*args), _gram_fns(name)[2](*args), None
        torch.cuda.synchronize()
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        errs[name] = _compare(f"{name} {tag}", out_k, out_p, out_p[0].dtype, live,
                              gram=name in ("band_gram", "syrk"))
    return errs


def sharded_config(label, mesh):
    """One (phase, ranks) entry of SHARDED on this rank: the f64 plain step
    on the ranks against the single-process one (rank 0, rel <= 1e-9); one
    f32 kernel step's collectives (the domain-decomposed step's all-gather
    budget at scale_1024); the f32 two-phase solve through the kernels
    between a reset and a read of the launch counts, timed, its collectives
    recorded; each launched kernel against its plain version on this rank's
    operands; the f64 plain two-phase solve on the ranks, phase 2 with the
    f32 run's selection, within 1e-3 of the f32 final costs (both solves
    under deterministic()). Returns (the JSON result, the f32 final
    state)."""
    tag = f"{label}@{mesh.size} rank {mesh.rank}"
    kernels = PHASES[label][1]
    p64 = phase_problem(label, np.float64)
    sh64 = _shard(p64, mesh)
    step_n = ot.compute_step(*sh64[:6], 1e4, sh64[6], plain=True, mesh=mesh)
    rel64 = None
    if mesh.rank == 0:
        state, _, cams, tables, plan, free, weights, huber = p64
        step_1 = ot.compute_step(state, cams, tables, plan, free, weights, 1e4, huber,
                                 plain=True)
        rel64 = max([rel(a, b) for a, b in zip(step_n[0], step_1[0])]
                    + [rel(a, b) for a, b in zip(step_n[1:], step_1[1:])])
        if not rel64 <= 1e-9:
            raise AssertionError(f"{tag}: f64 plain step on {mesh.size} ranks vs one process "
                                 f"rel {rel64:.3e} > 1e-9")

    p32 = phase_problem(label, np.float32)
    sh32 = _shard(p32, mesh)
    with par.audit.recording() as records:
        ot.compute_step(*sh32[:6], 1e4, sh32[6], mesh=mesh)  # also the warm-up
    step_ops = par.audit.collect_collectives(records)
    if label == BAND_SOLVE_PHASE:
        h = schur_mod._dd_domains(mesh, SCALE["n_poses"] // 64)
        gathers = step_ops["all-gather"]
        for shape in gathers["shapes"]:
            dims = [int(d) for d in shape[shape.index("[") + 1:-1].split(",")]
            if not (shape.startswith("f32") and math.prod(dims) <= h * 384 * 512):
                raise AssertionError(f"{tag}: all-gather {shape} past (h, 384, 512) f32")
        if not gathers["bytes"] < DD_GATHER_BYTES:
            raise AssertionError(f"{tag}: {gathers['bytes']} B of all-gathers per step")

    state, cams, tables, plan, free, weights, huber = sh32
    aux = TwoPhaseAux(is_ltm_obj=torch.zeros(state.objects.shape[0], dtype=torch.bool,
                                             device=state.objects.device),
                      shape_live=tables.shape.mask)
    spies = {name: Spy(ops, WRAPPER_NAMES[name]) for name in kernels}
    with contextlib.ExitStack() as stack:
        stack.enter_context(deterministic())
        for spy in spies.values():
            stack.enter_context(spy)
        selection = stack.enter_context(Spy(tp_mod, "reweight_on_device"))
        records = stack.enter_context(par.audit.recording())
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        schur_mod.reset_path_counts()
        t0 = time.perf_counter()
        final, s1, s2 = solve_two_phase(state, cams, tables, plan, free, weights, aux,
                                        LMParams(), LMParams(), huber, TwoPhaseConfig(),
                                        mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.kernel_launches()
        paths = dict(schur_mod.path_counts)
    iters = s1.num_iterations + s2.num_iterations
    check_result(final, (s1, s2), f"{tag} f32 kernels")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    if paths.get(SHARDED_PATHS[label]) != iters:
        raise AssertionError(f"{tag}: {paths} over {iters} LM iterations")
    errs = check_kernels_on_shard(spies, tag)

    weights2 = schur_mod.FactorWeights(*(w.double() for w in selection.result))
    with deterministic():
        _, r1 = solve(*sh64[:6], LMParams(), sh64[6], plain=True, mesh=mesh)
        _, r2 = solve(*sh64[:5], weights2, LMParams(), sh64[6], plain=True, mesh=mesh)
    gaps = [abs(a.final_cost - b.final_cost) / b.final_cost for a, b in ((s1, r1), (s2, r2))]
    if not max(gaps) <= 1e-3:
        raise AssertionError(f"{tag}: final cost gaps f32 kernels vs f64 plain {gaps} > 1e-3")
    return dict(
        rel64=rel64, iters=iters, wall_s=wall, ms_per_iter=1e3 * wall / iters,
        costs=[s1.final_cost, s2.final_cost], gaps=gaps, launches=launches, paths=paths,
        errs=errs, step_collectives=step_ops,
        collectives_per_iter=_per_iteration(par.audit.collect_collectives(records), iters),
    ), [x.cpu() for x in final]


def sharded_rank(rank, world, port, out_dir):
    """The body of a rank of the sharded phase: joins the gloo group at
    localhost:``port``, runs every SHARDED entry it takes part in, saves each
    f32 final state to ``out_dir`` and prints its results as one JSON line."""
    import datetime

    import torch.distributed as dist

    preconditions()
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    pair = dist.new_group([0, 1])
    results = {}
    for label, n in SHARDED:
        if rank < n:
            mesh = par.make_mesh(group=None if n == world else pair, device=DEVICE)
            results[f"{label}@{n}"], final = sharded_config(label, mesh)
            torch.save(final, Path(out_dir) / f"{label}@{n}_rank{rank}.pt")
        dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(results))


def start_sharded_ranks(out_dir, command=None):
    """The sharded phase's SHARDED_RANKS ranks, each a process of its own on
    the card: [(process, stdout file, stderr file)]."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    command = command or [sys.executable, str(Path(__file__).resolve())]
    ranks = []
    for r in range(SHARDED_RANKS):
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        ranks.append((subprocess.Popen(
            command + [SHARDED_RANK_ARG, str(r), str(SHARDED_RANKS), str(port), str(out_dir)],
            stdout=out, stderr=err, cwd=str(REPO)), out, err))
    return ranks


def join_sharded_ranks(ranks, out_dir, t_start):
    """Waits for the ranks (all stopped as soon as one fails, or at
    SHARDED_TIMEOUT_S), checks that the ranks of each entry ended in the
    same state bit for bit, prints what each entry measured and returns
    {entry: [launches per rank]}."""
    deadline = time.perf_counter() + SHARDED_TIMEOUT_S
    while any(p.poll() is None for p, _, _ in ranks):
        if time.perf_counter() > deadline or any(p.poll() for p, _, _ in ranks):
            break
        time.sleep(0.5)
    time.sleep(1.0)
    stop_session_processes({r: w for r, w in enumerate(ranks)})
    results = []
    for r, (proc, out, err) in enumerate(ranks):
        out.seek(0)
        err.seek(0)
        text = out.read()
        if proc.returncode != 0:
            raise RuntimeError(f"sharded rank {r}: exit code {proc.returncode}\n"
                               f"{text[-3000:]}\n{err.read()[-6000:]}")
        results.append(json.loads(text.strip().splitlines()[-1]))
    print(f"sharded phase: joined {time.perf_counter() - t_start:.1f} s after its start")
    launches = {}
    for label, n in SHARDED:
        key = f"{label}@{n}"
        finals = [torch.load(Path(out_dir) / f"{key}_rank{r}.pt") for r in range(n)]
        if not all(torch.equal(a, b) for f in finals[1:] for a, b in zip(f, finals[0])):
            raise AssertionError(f"{key}: the ranks' final states differ")
        res = [results[r][key] for r in range(n)]
        r0 = res[0]
        launches[key] = [x["launches"] for x in res]
        per_iter = ", ".join(f"{op} {v['count']:.2f} ({v['bytes'] / 1e6:.3f} MB)"
                             for op, v in r0["collectives_per_iter"].items())
        step = ", ".join(f"{op} {v['count']} ({v['bytes'] / 1e6:.3f} MB; {v['shapes'][:6]})"
                         for op, v in r0["step_collectives"].items())
        print(f"sharded {key} (ranks sharing one card over gloo: correctness and traffic, "
              f"not scaling): f64 plain step vs one process rel {r0['rel64']:.3e}; f32 "
              f"two-phase {r0['iters']} LM iterations in {r0['wall_s']:.4f} s, "
              f"{r0['ms_per_iter']:.3f} ms per LM iteration; final costs {r0['costs']}, gaps "
              f"to f64 plain {r0['gaps']}; paths {r0['paths']}")
        print(f"sharded {key} collectives per LM iteration: {per_iter}; one f32 step: {step}")
        for r, x in enumerate(res):
            print(f"sharded {key} rank {r}: launches {x['launches']}; kernel vs plain on the "
                  "rank's operands max abs err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in x["errs"].items()))
    return launches


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
        mini_ba=list(run.get("mini_ba", (0, 0))), launches=ops.kernel_launches(),
        graphs=dict(lm_fused.graph_stats))))


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
        launches=ops.kernel_launches(), graphs=dict(lm_fused.graph_stats))


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
    """Kills every process of ``workers`` still running (with its process
    group where it leads one)."""
    import signal

    for proc, _, _ in workers.values():
        if proc.poll() is None:
            if os.getpgid(proc.pid) == proc.pid:
                os.killpg(proc.pid, signal.SIGKILL)
            else:
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
              f"{mini}, online portion {r['online_s']:.4f} s, final {r['final_s']:.4f} s; "
              f"graphs {r['graphs']}")
        if not r["graphs"]["replays"]:
            raise AssertionError(f"the plain {label} run replayed no CUDA graph")
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
          f"{r['online_s']:.4f} s, {r['iterations']} LM iterations, launches {r['launches']}; "
          f"graphs {r['graphs']}")
    if not r["again"]:
        raise AssertionError("objects: the second session re-associated no map object")
    if not all(r["launches"][k] for k in OBJECTS_KERNELS):
        raise AssertionError(f"objects second session launches {r['launches']}")


# ---- debug images, host tools, the one-session pipeline, the frontend on
# ranks and the FLOP model ----------------------------------------------------

# The one-session pipeline: a visual-only stereo session exported in the
# reference's formats, run by ``single_trajectory_estimator --sparsify`` (the
# port's sparsifier at PIPELINE_TRANSL m, then its main entry point on the
# card) in a process of its own, at the reference's default config.
PIPELINE = dict(n_frames=32, n_features=600, seed=9)
PIPELINE_TRANSL = 0.4
PIPELINE_TIMEOUT_S = 600
# The frontend on ranks: a short stereo object session (four chairs) at the
# default config plus the chair prior (every frame a global BA, sharded),
# through the main entry point with ``--shard_devices 2``, each rank a gloo
# process on the one card (``chip_smoke.py --frontend-rank r 2 port dir``).
FRONTEND_RANKS = dict(n_frames=12, n_features=300, n_objects=4, seed=21, baseline=0.12,
                      odom_noise=0.01)
FRONTEND_RANK_ARG = "--frontend-rank"
FRONTEND_MIN_OBJECTS = 3
# The phases whose LM iteration the FLOP model is set beside.
FLOPS_PHASES = ("global", "window", "scale_1024")
# The overlays of the card against the CPU's.
OVERLAY_RTOL = 1e-9


def _matplotlib():
    """True when matplotlib is installed; else prints why the plots are not
    drawn."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: the iteration and --plots_dir plots are not drawn")
        return False
    return True


def _overlay_values(ov):
    """A frame's predicted boxes and reprojections as one vector."""
    return np.concatenate([np.ravel(p) for _, _, p in ov.predicted]
                          + [r for r in ov.reprojections if r is not None] + [np.zeros(0)])


def visualize_phase(tmp, objects):
    """The debug images' overlays of every frame of the object session's
    final pose graph and frontend, on the card in f64 and on the CPU in f64:
    equal counts, box corners and reprojections within OVERLAY_RTOL; ms per
    frame on the card; the PNGs when PIL is installed."""
    import importlib.util

    from obvi_slam_tpu_torch import visualization as viz

    run = objects["run"]
    pg, fe, config = run["pg"], run["frontend"], run["config"]
    fe_params = config.feature_based_bb_association_params
    vis_config = viz.SaveToFileVisualizerConfig(fe_params.feature_validity_window,
                                                fe_params.bounding_box_inflation_size)
    out = Path(tmp) / "debug_images"
    card = viz.SaveToFileVisualizer(str(out), vis_config, img_heights_and_widths=fe.img_hw,
                                    device=DEVICE)
    host = viz.SaveToFileVisualizer(str(out), vis_config, device="cpu")
    frames = sorted(pg.robot_poses)
    card.frame_overlays(pg, fe, frames[-1])  # warm-up
    overlays, times = [], []
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ov = card.frame_overlays(pg, fe, frame)
        times.append(time.perf_counter() - t0)
        overlays.append(ov)
    worst, n = 0.0, 0
    for frame, ov in zip(frames, overlays):
        ref = host.frame_overlays(pg, fe, frame)
        if (ov is None) != (ref is None):
            raise AssertionError(f"visualize frame {frame}: overlays on one device only")
        if ov is None:
            continue
        n += ov.count()
        keys = [(c, o) for c, o, _ in ov.predicted]
        if (ov.count() != ref.count() or keys != [(c, o) for c, o, _ in ref.predicted]
                or [r is None for r in ov.reprojections]
                != [r is None for r in ref.reprojections]):
            raise AssertionError(f"visualize frame {frame}: card {ov.count()} overlays, "
                                 f"CPU {ref.count()}")
        a, b = _overlay_values(ov), _overlay_values(ref)
        if a.size:
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
        if not np.allclose(a, b, rtol=OVERLAY_RTOL, atol=0):
            raise AssertionError(f"visualize frame {frame}: card and CPU overlays differ by "
                                 f"{worst:.3e}")
    print(f"visualize on {card_line()}: {len(frames)} frames, {n} overlays (predicted boxes "
          f"{sum(len(o.predicted) for o in overlays if o)}, reprojections "
          f"{sum(r is not None for o in overlays if o for r in o.reprojections)}), f64 card "
          f"vs CPU equal counts, worst relative difference {worst:.3e}; "
          f"{statistics.median(times) * 1e3:.3f} ms per frame median on the card "
          f"({sum(times) * 1e3 / len(times):.3f} mean, max {max(times) * 1e3:.3f})")
    if importlib.util.find_spec("PIL") is None:
        print("PIL is not installed: the debug images are not drawn")
        return
    t0 = time.perf_counter()
    paths = [p for ov in overlays if ov is not None for p in card.draw(ov)]
    print(f"visualize: {len(paths)} debug images drawn in {time.perf_counter() - t0:.3f} s")


def _tool(label, module, argv, seconds):
    """``module.main(argv)`` in process; must return 0; notes its host
    seconds."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        code = module.main(argv)
    seconds[label] = time.perf_counter() - t0
    if code not in (0, None):
        raise AssertionError(f"tools: {label} returned {code}")


def tools_phase(tmp, exported, objects):
    """The host tools on the object session's files and written outputs, in
    process, each returning 0 and its outputs read back through the port's
    readers: the sparsifier and the interpolator, the trajectory length and
    the re-keying by timestamp, the metrics of the sequence and of the
    approach (each ATE equal to the aligned ATE of the in-memory trajectory
    within 1e-9 m), the timing analysis, the LTM dump and, with matplotlib,
    the iteration and top-down plots. Prints each tool's host seconds."""
    from obvi_slam_tpu_torch import io as pio
    from obvi_slam_tpu_torch import metrics
    from obvi_slam_tpu_torch.cli import (
        compute_metrics_for_approach,
        compute_metrics_for_sequence,
        display_ltm,
        interpolate_poses_with_required_nodes,
        iteration_plotter,
        orb_trajectory_sparsifier,
        timing_analysis,
        traj_length_evaluator,
        utvslam_out_to_poses_by_timestamp,
    )
    from obvi_slam_tpu_torch.io import timestamped as tio
    from obvi_slam_tpu_torch.metrics import schema

    directory, gt, _ = exported
    src, results, work = Path(directory), Path(tmp) / "objects_out", Path(tmp) / "tools"
    work.mkdir()
    pg, seconds = objects["run"]["pg"], {}
    n = len(gt)
    est = np.stack([pg.get_robot_pose(i) for i in range(n)])
    ate_mem = metrics.ate_for_synced_aligned(
        metrics.align_with_ground_truth(gt, est), gt).rmse_transl_err

    _tool("orb_trajectory_sparsifier", orb_trajectory_sparsifier, [
        "--input_poses_file", str(src / "poses.csv"),
        "--input_feature_obs_dir", str(src / "orb_out"),
        "--output_poses_file", str(work / "sparse" / "poses.csv"),
        "--output_feature_obs_dir", str(work / "sparse" / "orb_out")], seconds)
    kept = pio.read_poses_by_node_id(str(work / "sparse" / "poses.csv"))
    tracks, _ = pio.read_orb_output_directory(str(work / "sparse" / "orb_out"))
    stamps = [(1000 + i, 250_000_000) for i in range(n)]
    tio.write_poses_with_timestamps(str(work / "est_by_ts.csv"), list(zip(stamps, est)))
    tio.write_timestamps(str(work / "required.csv"),
                         [(1000 + i, 750_000_000) for i in range(n - 1)])
    _tool("interpolate_poses_with_required_nodes", interpolate_poses_with_required_nodes, [
        "--poses_by_timestamp_file", str(work / "est_by_ts.csv"),
        "--required_timestamps_file", str(work / "required.csv"),
        "--poses_out_file", str(work / "interp.csv")], seconds)
    interp = tio.read_poses_with_timestamps(str(work / "interp.csv"))
    tio.write_node_ids_and_timestamps(str(work / "nodes.csv"), list(enumerate(stamps)))
    _tool("utvslam_out_to_poses_by_timestamp", utvslam_out_to_poses_by_timestamp, [
        "--poses_by_frame_file", str(results / "robot_poses.csv"),
        "--frames_for_timestamps_file", str(work / "nodes.csv"),
        "--poses_by_timestamp_out_file", str(work / "est" / "s" / "trajectory.csv")], seconds)
    by_ts = tio.read_optional_poses_with_timestamps(str(work / "est" / "s" / "trajectory.csv"))
    tio.write_poses_with_timestamps(
        str(work / "gt" / "s" / "interpolated_lego_loam_poses.csv"), list(zip(stamps, gt)))
    _tool("traj_length_evaluator", traj_length_evaluator, [
        "--trajectory_files", f"{work / 'interp.csv'},{work / 'est_by_ts.csv'}",
        "--output_file", str(work / "lengths.json")], seconds)
    lengths = json.loads((work / "lengths.json").read_text())
    if not (len(kept) > 1 and tracks and len(interp) == n - 1 and len(by_ts) == n
            and lengths["total"] > 0):
        raise AssertionError(f"tools: {len(kept)} sparsified poses, {len(tracks)} tracks, "
                             f"{len(interp)} interpolated, {len(by_ts)} re-keyed")

    sessions = [dict(name="objects", est_trajectory_file=str(results / "robot_poses.csv"),
                     gt_trajectory_file=str(src / "gt_poses.csv"))]
    (work / "sessions.json").write_text(json.dumps(sessions))
    plots = _matplotlib()
    _tool("compute_metrics_for_sequence", compute_metrics_for_sequence, [
        "--sequence_results_file", str(work / "sessions.json"),
        "--metrics_out_file", str(work / "sequence.json"),
        "--ref_schema_out_file", str(work / "sequence_ref.json"),
        *(["--plots_dir", str(work / "plots")] if plots else [])], seconds)
    seq_ate = json.loads((work / "sequence.json").read_text())[
        "indiv_trajectory_metrics"][0]["rmse_transl_err"]
    ref_ate = schema.read_metrics_file(str(work / "sequence_ref.json"))[0]["ate"].rmse_transl_err
    _tool("compute_metrics_for_approach", compute_metrics_for_approach, [
        "--single_trajectory_eval_base_name", "s",
        "--comparison_alg_traj_est_dir", str(work / "est"),
        "--interpolated_gt_traj_dir", str(work / "gt"),
        "--metrics_out_file", str(work / "approach.json")], seconds)
    approach_ate = schema.read_metrics_file(str(work / "approach.json"))[0]["ate"].rmse_transl_err
    for label, value in (("sequence", seq_ate), ("sequence reference schema", ref_ate),
                         ("approach", approach_ate)):
        if not abs(value - ate_mem) <= 1e-9:
            raise AssertionError(f"tools: {label} ATE {value!r} vs in memory {ate_mem!r}")
    _tool("timing_analysis", timing_analysis, [str(results / "timing.json")], seconds)
    _tool("display_ltm", display_ltm, [str(results / "ltm.json"), "--covariances"], seconds)
    if plots:
        _tool("iteration_plotter", iteration_plotter, [
            "--logs_directory", str(results / "logs"), "--plots_dir", str(work / "iterations")],
            seconds)
        drawn = sorted(p.name for d in ("plots", "iterations") for p in (work / d).glob("*.png"))
        print(f"tools: plots drawn {drawn}")
    print(f"tools (in process, on the object session's files): aligned ATE {ate_mem:.9f} m in "
          f"memory, {seq_ate:.9f} (sequence), {approach_ate:.9f} (approach); "
          f"{len(kept)} of {n} frames kept by the sparsifier; host seconds "
          + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items()))


def start_pipeline(tmp):
    """The one-session pipeline's session exported into ``tmp`` and its
    ``single_trajectory_estimator`` started in a process group of its own:
    (process, stdout file, stderr file), the directory, the ground truth
    and the initial poses."""
    from obvi_slam_tpu_torch.synthetic import export_session_files

    data, gt, _ = ot.synthetic_session(**PIPELINE)
    d = export_session_files(data, gt, Path(tmp) / "pipeline")
    (d / "orb_out" / "poses").mkdir()
    (d / "orb_out" / "poses" / "initial_robot_poses_by_node.txt").write_bytes(
        (d / "poses.csv").read_bytes())
    ot.config.write_config(ot.config.FullOVSLAMConfig(), str(d / "config.json"))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "obvi_slam_tpu_torch.cli.single_trajectory_estimator",
         "--params_config_file", str(d / "config.json"),
         "--intrinsics_file", str(d / "intrinsics.csv"),
         "--extrinsics_file", str(d / "extrinsics.csv"), "--orb_out_dir", str(d / "orb_out"),
         "--output_dir", str(d / "out"), "--sparsify",
         "--max_pose_inc_threshold_transl", str(PIPELINE_TRANSL), "--device", DEVICE],
        stdout=out, stderr=err, cwd=str(REPO), start_new_session=True)
    return (proc, out, err), d, gt, data.initial_poses, time.perf_counter()


def check_pipeline(worker, d, gt, initial, t_start):
    """Joins the pipeline's process; its ATE against the ground truth of
    the frames the sparsifier kept must be below half the odometry's, and
    every output must read back."""
    from obvi_slam_tpu_torch import io as pio
    from obvi_slam_tpu_torch.cli.orb_trajectory_sparsifier import get_sparsified_frames

    proc, out, err = worker
    try:
        rc = proc.wait(timeout=PIPELINE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = "timeout"
    out.seek(0)
    err.seek(0)
    if rc != 0:
        raise RuntimeError(f"pipeline: exit code {rc}\n{out.read()[-2000:]}\n{err.read()[-6000:]}")
    wall = time.perf_counter() - t_start
    res = d / "out"
    mapping = get_sparsified_frames(initial, PIPELINE_TRANSL, 0.1, set())
    sparse = pio.read_poses_by_node_id(str(res / "sparsified_poses.csv"))
    poses = pio.read_poses_by_node_id(str(res / "robot_poses.csv"))
    if sorted(mapping.values()) != sorted(sparse) or sorted(poses) != sorted(sparse):
        raise AssertionError(f"pipeline: {len(mapping)} frames kept, {len(sparse)} in the "
                             f"sparsified poses, {len(poses)} estimated")
    old = sorted(mapping, key=mapping.get)
    kept_gt = gt[old]
    ate = _ate(poses, kept_gt)
    odom = _ate({mapping[f]: initial[f] for f in old}, kept_gt)
    n_features = len((res / "features.csv").read_text().strip().splitlines()) - 1
    ltm = ot.LongTermObjectMap.load(str(res / "long_term_map.json"))
    timing = json.loads((res / "timing.json").read_text())
    rows = (res / "ceres_opt_summary.csv").read_text().strip().splitlines()[1:]
    ellipsoids = (res / "ellipsoids.csv").read_text().splitlines()
    if not (ate < 0.5 * odom and n_features > 0 and rows and ellipsoids
            and "offline_runner_online_portion" in timing
            and (res / "checkpoints" / "pose_graph_state.json").exists()):
        raise AssertionError(f"pipeline: ATE {ate:.6f} m (odometry {odom:.6f} m), "
                             f"{n_features} features, {len(rows)} solves")
    print(f"pipeline (single_trajectory_estimator --sparsify --device {DEVICE}, a process "
          f"of its own): {len(poses)} of {PIPELINE['n_frames']} frames kept at "
          f"{PIPELINE_TRANSL} m; ATE {ate:.6f} m (odometry {odom:.6f} m); {len(rows)} solves, "
          f"{n_features} features, {len(ltm.ellipsoids)} map objects; online portion "
          f"{timing['offline_runner_online_portion']['total_s']:.4f} s; joined "
          f"{wall:.1f} s after its start")


def frontend_rank(rank, world, port, out_dir):
    """The body of a rank of the frontend phase: joins the gloo group at
    localhost:``port``, runs the session exported in ``out_dir/files``
    through the main entry point's ``build_session`` and ``run_session``
    with ``--shard_devices world`` (the global-BA solves sharded, the
    frontend's estimates from rank 0), extracts the long-term map with
    deterministic algorithms, and saves its pose graph, map and frontend
    differences to ``out_dir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    preconditions()
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    cli_main.parallel.initialize_distributed = lambda **kwargs: True  # joined above
    files = Path(out_dir) / "files"
    # The parser alone: parse_args refuses more ranks than CUDA devices,
    # and these ranks share the one card over gloo.
    args = cli_main.build_parser().parse_args(
        object_argv(files, "--shard_devices", str(world)))
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    session = cli_main.build_session(args)
    if not cli_main.run_session(session):
        raise AssertionError(f"frontend rank {rank}: run_optimization returned False")
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    ltm = ot.extract_long_term_object_map(
        session.pg, session.config, session.bb_frontend.get_front_end_obj_map_data(),
        caps=session.runner.caps_pool("global"), device=DEVICE)
    torch.use_deterministic_algorithms(False)
    fe = session.bb_frontend
    result = dict(state=session.pg.get_state(), ltm=None if ltm is None else ltm.to_json(),
                  differences=fe.rank_differences,
                  pending=[None if p.object_estimate is None else p.object_estimate.tolist()
                           for p in fe.pending],
                  log=[(r.frame_id, r.phase, r.final_cost, r.iterations)
                       for r in session.runner.opt_log])
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    print(json.dumps(dict(wall=wall, launches=launches, objects=len(session.pg.objects))))


def start_frontend_ranks(tmp, command=None):
    """The frontend phase's session written into ``tmp/frontend_ranks`` and
    its two rank processes started on the card: [(process, stdout file,
    stderr file)], the directory."""
    import socket

    from obvi_slam_tpu_torch.synthetic import export_session_files

    out_dir = Path(tmp) / "frontend_ranks"
    data, gt, _ = ot.synthetic_object_session(**FRONTEND_RANKS)
    d = export_session_files(data, gt, out_dir / "files")
    config = ot.config.FullOVSLAMConfig()
    mean, std = CHAIR_PRIOR
    config.shape_dimension_priors = [ot.config.ShapeDimensionPrior(
        "chair", np.array(mean), np.diag(np.array(std) ** 2))]
    ot.config.write_config(config, str(d / "config.json"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    command = command or [sys.executable, str(Path(__file__).resolve())]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    ranks = []
    for r in range(2):
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        ranks.append((subprocess.Popen(
            command + [FRONTEND_RANK_ARG, str(r), "2", str(port), str(out_dir)],
            stdout=out, stderr=err, cwd=str(REPO), env=env), out, err))
    return ranks, out_dir, time.perf_counter()


def check_frontend_ranks(ranks, out_dir, t_start):
    """Joins the frontend ranks: their pose graphs, long-term maps, pending
    estimates and solve logs equal bit for bit, at least
    FRONTEND_MIN_OBJECTS chairs initialised, the frontend's broadcasts made;
    prints the broadcasts and the largest difference rank 1's estimates had
    from rank 0's before them."""
    deadline = time.perf_counter() + SHARDED_TIMEOUT_S
    while any(p.poll() is None for p, _, _ in ranks):
        if time.perf_counter() > deadline or any(p.poll() for p, _, _ in ranks):
            break
        time.sleep(0.5)
    time.sleep(1.0)
    stop_session_processes({r: w for r, w in enumerate(ranks)})
    summaries = []
    for r, (proc, out, err) in enumerate(ranks):
        out.seek(0)
        err.seek(0)
        text = out.read()
        if proc.returncode != 0:
            raise RuntimeError(f"frontend rank {r}: exit code {proc.returncode}\n"
                               f"{text[-3000:]}\n{err.read()[-6000:]}")
        summaries.append(json.loads(text.strip().splitlines()[-1]))
    r0, r1 = (json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2))
    for key in ("state", "ltm", "pending", "log"):
        if r0[key] != r1[key]:
            raise AssertionError(f"frontend ranks: the ranks' {key} differ")
    n_objects = len(r0["state"]["objects"])
    if n_objects < FRONTEND_MIN_OBJECTS or r0["ltm"] is None or not r0["differences"]:
        raise AssertionError(f"frontend ranks: {n_objects} objects, LTM "
                             f"{r0['ltm'] is not None}, {len(r0['differences'])} broadcasts")
    for r, summary in enumerate(summaries):
        if not all(summary["launches"][k] for k in OBJECTS_KERNELS):
            raise AssertionError(f"frontend rank {r}: launches {summary['launches']}")
    if any(r0["differences"]):
        raise AssertionError("frontend ranks: rank 0 differed from itself")
    diffs = r1["differences"]
    print(f"frontend ranks ({FRONTEND_RANKS['n_frames']} frames, {n_objects} objects, 2 gloo "
          f"ranks on the one card through the main entry point with --shard_devices 2): pose "
          f"graphs, LTM ({len(r0['ltm']['ellipsoids'])} objects), pending estimates and solve "
          f"logs equal bit for bit; {len(diffs)} frontend broadcasts; rank 1's estimates before "
          f"them differed from rank 0's in {sum(d > 0 for d in diffs)}, by at most "
          f"{max(diffs):.3e}; session wall {summaries[0]['wall']:.2f} s, launches "
          f"{summaries[0]['launches']}; joined {time.perf_counter() - t_start:.1f} s after "
          "its start")


def flops_phase(device_ms):
    """The FLOP model of one LM iteration (``flops.lm_iteration_flops``, the
    reference's model of the step) of each FLOPS_PHASES problem beside its
    device ms per LM iteration from ``profile_phase``: per-phase flops and
    time at the f32 peak, the dominant phase, the modelled fraction."""
    from obvi_slam_tpu_torch import flops

    for label in FLOPS_PHASES:
        state, _, _, tables, plan = phase_problem(label, np.float32)[:5]
        n_pose, n_point, n_obj = (int(x.shape[0]) for x in state)
        phases = flops.lm_iteration_flops(tables, plan, n_pose, n_point, n_obj)
        ms = device_ms.get(label)
        table = flops.speed_of_light_table(phases, None if not ms else ms * 1e-3)
        top = max(phases, key=lambda k: phases[k]["flops_f32"])
        print(f"flops {label} ({n_pose} x {n_point} x {n_obj}, the reference's model of the "
              "step): " + "; ".join(f"{k} {v['flops_f32']:.4e} ({v['sol_us']:.3f} us)"
                                    for k, v in table["phases"].items()))
        fraction = table.get("sol_fraction")
        print(f"flops {label}: total {table['total_flops_f32']:.4e} flop, "
              f"{table['total_sol_us']:.3f} us at {flops.PEAK_F32_FLOPS:.3g} flop/s; dominant "
              f"{top} ({phases[top]['flops_f32'] / table['total_flops_f32']:.4f} of the "
              f"model); measured device time {ms if ms else float('nan'):.3f} ms per LM "
              f"iteration, modelled fraction "
              f"{'not measured' if fraction is None else f'{fraction:.4f}'}")


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
        sharded_dir = Path(tmp.name) / "sharded"
        sharded_dir.mkdir()
        t_sharded = time.perf_counter()
        sharded = start_sharded_ranks(sharded_dir)
        workers.update({f"sharded rank {r}": w for r, w in enumerate(sharded)})
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
        check_relabelled_step()
        print(f"[{time.perf_counter() - t_start:.1f} s] checks done")
        phases = {label: main_path_phase(label) for label in PHASES}
        fixed_iterations("global")
        fixed_iterations("scale_1024", n_iters=10)
        fixed_iterations("loop_1024", n_iters=10)
        print(f"[{time.perf_counter() - t_start:.1f} s] synthetic phases done")
        for label in PHASES:
            fused_phase(label, phases[label])
        print(f"[{time.perf_counter() - t_start:.1f} s] fused phase done")
        sharded_launches = join_sharded_ranks(sharded, sharded_dir, t_sharded)
        print(f"[{time.perf_counter() - t_start:.1f} s] sharded phase done")
        pipeline = start_pipeline(tmp.name)
        workers["pipeline"] = pipeline[0]
        frontend = start_frontend_ranks(tmp.name)
        workers.update({f"frontend rank {r}": w for r, w in enumerate(frontend[0])})
        session = session_phase()
        errs["syrk"] = max(errs["syrk"], check_session_gram(session["syrk_operand"]))
        errs["reproj"] = max(errs["reproj"], check_session_reproj(*session["reproj_operands"]))
        print(f"[{time.perf_counter() - t_start:.1f} s] session phase done")
        objects = objects_phase(tmp.name, exported["objects"])
        workers["second"] = start_session_process(
            "second", str(exported["second"][0]), objects["ltm_path"],
            str(Path(tmp.name) / "second_out"))
        print(f"[{time.perf_counter() - t_start:.1f} s] objects phase done")
        oracle_phase(tmp.name, exported["objects"])
        mini_ba_padding_check()
        bbox_err, reproj_err = check_object_tables(
            objects["window"], objects["mini"], objects["mini_reproj"])
        errs["bbox"] = max(errs["bbox"], bbox_err)
        errs["reproj"] = max(errs["reproj"], reproj_err)
        visualize_phase(tmp.name, objects)
        tools_phase(tmp.name, exported["objects"], objects)
        print(f"[{time.perf_counter() - t_start:.1f} s] visualize and tools phases done")
        rows = time_kernels(errs, phases, gram_ops, session, objects)
        print(f"[{time.perf_counter() - t_start:.1f} s] kernel timings done")
        device_ms = {label: profile_phase(label, ph) for label, ph in phases.items()}
        profile_session(session["run"])
        profile_objects(objects["run"])
        print(f"[{time.perf_counter() - t_start:.1f} s] profiles done")
        flops_phase(device_ms)
        check_frontend_ranks(*frontend)
        check_pipeline(*pipeline)
        print(f"[{time.perf_counter() - t_start:.1f} s] frontend ranks and pipeline joined")
        check_session_processes(join_session_processes(
            {k: workers[k] for k in ("session", "objects", "second")}), session, objects)
        for row in rows:
            row["sharded_launches"] = {key: [x[row["name"]] for x in per_rank]
                                       for key, per_rank in sharded_launches.items()}
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
    elif len(sys.argv) >= 3 and sys.argv[1] == SHARDED_RANK_ARG:
        sharded_rank(*sys.argv[2:])
    elif len(sys.argv) >= 3 and sys.argv[1] == FRONTEND_RANK_ARG:
        frontend_rank(*sys.argv[2:])
    else:
        main()
