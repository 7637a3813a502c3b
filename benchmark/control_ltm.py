"""Readings of the extraction's checks of an ``ltm`` cell beside their
controls, for setting their limits, seed by seed:

    python3 benchmark/control_ltm.py --seeds <n> [<n> ...] [--workload objects.ltm_revisit]

For each seed, one run of the cell's set-up and window, then one JSON line
{"seed", "program": {number: value}, "control": {number: value}}:
``program`` holds the cell's own checks; ``control`` holds

- ``covariance_error``: the program's marginal covariances of the same
  extraction problem computed in float32, the precision below the
  configuration's float64, against the reference;
- ``rank_repair_uncovered.all`` and ``.one_object``: the planted fault, the
  repair's priors taken out of the problem, all of them or those of the
  first object that has any, before the reference reads it.

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import control, harness  # noqa: E402


def _to(x, dtype):
    """``x`` (a tensor or a named tuple of them, nested) with its floating
    tensors in ``dtype``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dtype) for v in x))
    return x


def _f32_covariances(call):
    """The program's object covariances of one captured marginal-covariance
    call, recomputed with every floating input in float32 (float64 on the
    host)."""
    import torch

    from benchmark.drivers import session as session_driver
    from obvi_slam_tpu_torch.solver.schur import compute_marginal_covariances

    args, kwargs = call
    kwargs = {k: v for k, v in kwargs.items() if k != "return_reduced_hessian"}
    huber = args[6] if len(args) > 6 else kwargs.pop("huber")
    covs = compute_marginal_covariances(*(_to(a, torch.float32) for a in args[:6]),
                                        _to(huber, torch.float32), **kwargs)[0]
    return session_driver._host(covs).astype("float64")


def _planted(arrays):
    """{name: the arrays with the fault planted}: every prior row dropped,
    or those of the first object that has any."""
    import numpy as np

    held = np.asarray(arrays["prior_mask"], bool)
    objects = np.asarray(arrays["prior_block"])[held & (np.asarray(arrays["prior_kind"]) == 2)]
    one = held.copy()
    if objects.size:
        one &= ~((np.asarray(arrays["prior_kind"]) == 2)
                 & (np.asarray(arrays["prior_block"]) == objects.min()))
    return {"all": dict(arrays, prior_mask=np.zeros_like(held)),
            "one_object": dict(arrays, prior_mask=one)}


def readings(workload_name, seed, device="cuda", files=None):
    """(the cell's checks {number: value}, the controls {number: value}) of
    one run."""
    from benchmark.reference import build, covariance

    workload, config, driver = control._cell(workload_name, files or {})
    ctx = driver.setup(workload, config, seed, device)
    measured = driver.measure(ctx, float("inf"), harness.Tracer(False))
    f32 = _f32_covariances(ctx["extraction"]["calls"][-1])
    driver.release(ctx)
    program = {c.name: c.value for c in driver.check(ctx, measured)}
    ext = ctx["extraction"]
    prob = build.plain_problem(ext["arrays"], ext["huber"], device=device)
    rows = prob.keep["objects"]
    ref = covariance.marginal_covariances(prob)
    out = {"covariance_error": covariance.relative_error(f32[:len(ext["obj_rows"])][rows], ref)}
    for name, arrays in _planted(ext["arrays"]).items():
        planted = build.plain_problem(arrays, ext["huber"], device=device)
        out[f"rank_repair_uncovered.{name}"] = covariance.repair_uncovered(planted)[0]
    return program, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="objects.ltm_revisit")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        program, controls = readings(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": program,
                          "control": controls, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
