#!/usr/bin/env python3
"""Parent-versus-change timing of obvi_slam_tpu_torch on one NVIDIA card.

    python3 chip_ab.py TREE

imports ``obvi_slam_tpu_torch`` and the ``chip_smoke`` helpers of the
checkout at TREE (this repository at some commit, unpacked with ``git
archive``), builds its kernels and prints one JSON line with the card's name
and power limit and:

  - for the reprojection (K1) and bounding-box (K2) wrappers on the window's
    f32 tables: the device time of all device work per call and the device
    operations per call (torch.profiler), and the milliseconds per call of
    back-to-back calls between CUDA events (the host's issue time);
  - for each phase of the main path: three f32 two-phase solves after a
    warm-up, as (LM iterations, wall s, LM iterations/s, wall ms per
    iteration);
  - three fixed 20-iteration global solves (LM iterations/s).

Run two trees in turns (A, B, B, A) in one job on one card: numbers from
different jobs or cards do not compare.
"""

import json
import sys
import time
from pathlib import Path

TREE = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(TREE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (TREE's copy)
from obvi_slam_tpu_torch import ops  # noqa: E402
from obvi_slam_tpu_torch.ops import _build  # noqa: E402
from obvi_slam_tpu_torch.solver import LMParams, solve  # noqa: E402


def device_ops_per_call(fn, calls=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / calls


def main():
    cs.preconditions()
    _build.build()
    out = {"tree": str(TREE), "card": cs.card_line()}
    state, _, cams, tables, *_ = cs.problem(np.float32)
    for name, fn in (
        ("reproj", lambda: ops.reproj_residuals_and_jac(state, cams, tables.reproj)),
        ("bbox", lambda: ops.bbox_residuals_and_jac(state, cams, tables.bbox)),
    ):
        out[name] = dict(
            device_ms=cs.device_ms(fn, calls=50), device_ops_per_call=device_ops_per_call(fn),
            wrapper_event_ms=cs.time_ms(fn),
        )
    for label, (size, _) in cs.PHASES.items():
        problem = cs.problem(np.float32, size)
        cs.run_two_phase(problem, plain=False)  # warm-up
        runs = []
        for _ in range(3):
            _, s1, s2, wall = cs.run_two_phase(problem, plain=False)
            iters = s1.num_iterations + s2.num_iterations
            runs.append((iters, wall, iters / wall, wall * 1e3 / iters))
        out[label] = runs
    state, _, cams, tables, plan, free, weights, huber = cs.problem(np.float32, cs.GLOBAL)
    params = LMParams(max_num_iterations=20, function_tolerance=0.0, gradient_tolerance=0.0,
                      parameter_tolerance=0.0)
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, summary = solve(state, cams, tables, plan, free, weights, params, huber)
        torch.cuda.synchronize()
        rates.append(summary.num_iterations / (time.perf_counter() - t0))
    out["fixed20_global_it_per_s"] = rates
    print(json.dumps(out))


if __name__ == "__main__":
    main()
