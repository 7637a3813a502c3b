"""Readings of the numbers that decide ``correct``, for setting their limits:
the program's and the control's, seed by seed.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

The control computes in the next precision below the configuration's
float32 with TF32 off: TF32. A cell's workload file names it:
``"program_tf32"`` (the default) is the program on its own lower-precision
path, TF32 matmuls (``torch.backends.cuda.matmul.allow_tf32``), run through
the cell's set-up and a window of ``--seconds`` at the cell's own load;
``"reference_tf32"``, for a cell whose program takes no TF32 path, is the
reference put in the program's place, in float32 with the operands of its
Gauss-Newton products rounded to TF32 (the driver's ``reference_control``).
For each seed this reads the program as configured and the control, judged
by the plain reference, and prints one JSON line: {"seed", "program":
{number: value}, "control": {number: value}}. The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def _cell(workload_name, files):
    workload = files.get("workload") or harness.load_json(
        harness.BENCH_DIR / "workloads" / f"{workload_name}.json")
    config = files.get("config") or harness.load_json(
        harness.BENCH_DIR / "configs" / f"{workload['config']}.json")
    driver = harness.load_module(harness.BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                                 f"driver_{workload['driver']}")
    return workload, config, driver


def readings(workload_name, seed, seconds, device="cuda", files=None, tf32=False):
    """{number: value} of one run of the cell's set-up and window, judged by
    the reference; with ``tf32`` the program's matmuls take TF32."""
    import torch

    workload, config, driver = _cell(workload_name, files or {})
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        ctx = driver.setup(workload, config, seed, device)
        measured = driver.measure(ctx, seconds, harness.Tracer(False))
        driver.release(ctx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {c.name: c.value for c in driver.check(ctx, measured)}


def control_readings(workload_name, seed, seconds, device="cuda", files=None):
    """{number: value} of the cell's control (its workload's ``control``)."""
    workload, config, driver = _cell(workload_name, files or {})
    kind = workload.get("control", "program_tf32")
    if kind == "program_tf32":
        return readings(workload_name, seed, seconds, device, files, tf32=True)
    if kind == "reference_tf32":
        return driver.reference_control(workload, config, seed, device)
    raise ValueError(f"unknown control {kind!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control-only", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        program = {} if args.control_only else readings(args.workload, seed, args.seconds)
        control = control_readings(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": program,
                          "control": control, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
