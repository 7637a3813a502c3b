#!/usr/bin/env python3
"""Crossover of the loop-closure Schur paths on one card.

For each pose count, the ``chip_smoke.SCALE`` problem (16384 points, 64
objects, 6 observations a point, 12 an object) at that many poses is
relabelled out and back (``chip_smoke.out_and_back``: a loop closure), and
one f32 ``compute_step`` is timed on each way of assembling S that the
automatic choice takes when the point slot grid is over budget:

  - ``dense_from_pairs``: ``dense_schur=True`` with the slot budget set
    just below the point slot grid, so that the step builds the dense U
    from the pairs and its gram (and the object slot gram);
  - ``pairs``: ``dense_schur=False``, pair enumeration.

Each step is captured once as a CUDA graph and timed as the graph's replay
(``chip_smoke.time_ms``: CUDA events, the median of three runs of
``--replays`` replays) and as the device kernels' time per replay
(``chip_smoke.device_ms``: torch.profiler, the kernels' summed self time),
with its cuBLAS GEMM/SYRK share. Beside them: the dense U gram's
multiply-adds over the pair enumeration's (``schur.schur_work``, the ratio
the automatic choice compares with ``schur._PAIR_WORK_FACTOR``), the
shapes ``schur.choose_paths`` reads, and the relative gap between the pair
step's pose update and the dense one's.

Run from the repository root on the card (TF32 off, cuSOLVER):

    python3 schur_crossover.py [--poses 192 384 576 768] [--points 16384]
        [--obs-per-point 6] [--replays 30] [--out crossover.json]

One JSON line per pose count on standard output, all of them in ``--out``.
With ``--device cpu`` it runs each step once eagerly at the given sizes (a
rehearsal of the control flow; no time is reported).
"""


from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch.solver import schur as schur_mod


def problem(n_poses, args):
    """The out-and-back f32 problem at ``n_poses`` poses."""
    size = dict(chip_smoke.SCALE, n_poses=n_poses, n_points=args.points,
                n_objects=args.objects, obs_per_point=args.obs_per_point)
    prob = ot.synthetic_problem(**size, dtype=np.float32, device=args.device)
    return chip_smoke.out_and_back(prob)[0]


def budget_for(mode, plan, n_pose):
    """The slot budget each mode runs under: just below the point slot grid
    for ``dense_from_pairs`` (the object grid stays within it)."""
    if mode != "dense_from_pairs":
        return schur_mod._SLOT_BUDGET
    pt = int(np.prod(plan.pt_slot_gather.shape)) * n_pose
    ob = int(np.prod(plan.ob_slot_gather.shape)) * n_pose
    budget = min(pt - 1, schur_mod._SLOT_BUDGET)
    if ob > budget:
        raise ValueError(f"object slot grid {ob} over the point one {pt}")
    return budget


MODES = {"dense_from_pairs": True, "pairs": False}


def step_fn(prob, dense_schur):
    state, _, cams, tables, plan, free, weights, huber = prob
    radius = torch.tensor(1e4, dtype=state.poses.dtype, device=state.poses.device)

    def fn():
        return schur_mod.compute_step(state, cams, tables, plan, free, weights, radius, huber,
                                      dense_schur=dense_schur)
    return fn


def capture(fn):
    """``fn`` warmed up on a side stream, then captured: (graph, outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    torch.cuda.synchronize()
    return graph, out


def rel_gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def measure(n_pose, args):
    prob = problem(n_pose, args)
    plan = prob[4]
    n_point = prob[0].points.shape[0]
    dense, pairs = schur_mod.schur_work(plan, n_pose, n_point)
    line = dict(poses=n_pose, points=n_point, objects=prob[0].objects.shape[0],
                cross_rows=int(plan.pt_cross_a.shape[0]),
                pair_rows=int(plan.pt_pair_point.shape[0]),
                slot_grid=list(plan.pt_slot_gather.shape),
                dense_macs=dense, pair_macs=pairs, work_ratio=dense / pairs, modes={})
    deltas = {}
    for mode, dense_schur in MODES.items():
        keep = schur_mod._SLOT_BUDGET
        schur_mod._SLOT_BUDGET = budget_for(mode, plan, n_pose)
        try:
            fn = step_fn(prob, dense_schur)
            schur_mod.reset_path_counts()
            if args.device == "cpu":
                out = fn()
                entry = {}
            else:
                torch.cuda.reset_peak_memory_stats()
                graph, out = capture(fn)
                entry = dict(
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    replay_ms=chip_smoke.time_ms(graph.replay, inner=args.replays, reps=3),
                    device_ms=chip_smoke.device_ms(graph.replay, calls=args.replays),
                    gemm_ms=(chip_smoke.device_ms(graph.replay, "gemm", args.replays)
                             + chip_smoke.device_ms(graph.replay, "syrk", args.replays)))
            entry["paths"] = sorted(k for k in schur_mod.path_counts if k != "steps")
        finally:
            schur_mod._SLOT_BUDGET = keep
        deltas[mode] = out[0].poses.clone()
        line["modes"][mode] = entry
        del fn, out
        if args.device != "cpu":
            del graph
            torch.cuda.empty_cache()
    line["pose_gap_pairs_vs_dense"] = rel_gap(deltas["pairs"], deltas["dense_from_pairs"])
    if args.device != "cpu":
        m = line["modes"]
        line["dense_over_pairs_replay"] = (m["dense_from_pairs"]["replay_ms"]
                                           / m["pairs"]["replay_ms"])
        line["dense_over_pairs_device"] = (m["dense_from_pairs"]["device_ms"]
                                           / m["pairs"]["device_ms"])
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--poses", type=int, nargs="+", default=[192, 384, 576, 768])
    parser.add_argument("--points", type=int, default=chip_smoke.SCALE["n_points"])
    parser.add_argument("--objects", type=int, default=chip_smoke.SCALE["n_objects"])
    parser.add_argument("--obs-per-point", type=int, default=chip_smoke.SCALE["obs_per_point"])
    parser.add_argument("--replays", type=int, default=30)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("schur_crossover: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.preferred_linalg_library("cusolver")
    head = dict(device=chip_smoke.card_line() if args.device == "cuda" else "cpu")
    print(json.dumps(head), flush=True)
    lines = []
    for n_pose in args.poses:
        lines.append(measure(n_pose, args))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(head, lines=lines), indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
