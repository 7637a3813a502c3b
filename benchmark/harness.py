"""The benchmark's runner of one cell: set-up, the measured window, the
traced window, the correctness check and the result line.

Everything particular to a cell lives in files found by name:
``workloads/<cell>.json`` (its configuration, driver, traffic and limits),
``configs/<config>.json``, ``drivers/<driver>.py`` (``setup``, ``measure``,
``release``, ``check``) and ``metrics/<metric>.py`` (``read(record)``, one
per per-layer metric). ``BENCHMARK.json`` says which metrics a cell
reports. Adding a cell, a configuration or a metric adds files and edits
none.

A driver's ``measure(ctx, seconds, tracer)`` returns a ``Measured``: the
end-to-end values, the answers attempted and failed, and the record the
per-layer readers read (timers, counters, the traced window's summary).
``check(ctx, measured)`` returns the numbers compared with the plain
reference, each with its limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level modules that no run may load: JAX and the JAX package (the port's
# name begins with the JAX package's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "obvi_slam_tpu")
SPAN_PREFIX = "bench/"
TOP = 10


@dataclass
class Check:
    """One number compared with the reference; correct when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Measured:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    record: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (metric readers)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("/", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m["workloads"] or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def span(name: str):
    """A host span around a call into one of the program's layers, seen by
    the traced window (a no-op cost when the profiler is off)."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def wrap(obj, attr: str, name: str, after=None):
    """Replaces ``obj.attr`` by the same call inside span ``name``;
    ``after(args, kwargs, out)`` sees each call. Returns the original."""
    inner = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with span(name):
            out = inner(*args, **kwargs)
        if after is not None:
            after(args, kwargs, out)
        return out

    setattr(obj, attr, wrapped)
    return inner


class Tracer:
    """torch.profiler over the sub-window a driver chooses (``start`` and
    ``stop``, or ``with tracer:``), summarized by ``finish`` once the
    measured window has closed. Disabled, it does nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[dict] = None
        self._prof = None
        self._done = None

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def __enter__(self):
        if not self.enabled or self._done is not None or self._prof is not None:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._done = (self._prof, wall)
        self._prof = None
        return False

    def finish(self):
        """Summarizes the traced window, after the measured one."""
        if self._done is not None and self.summary is None:
            prof, wall = self._done
            self.summary = summarize(prof.events(), wall)
            self._done = None


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events, wall_s: float) -> dict:
    """Device busy seconds (the union of the device operations' intervals),
    device seconds and counts by operation name, and the idle gaps between
    device operations by the innermost benchmark span the host was in."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in events:
        user = getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
        if e.device_type == DeviceType.CUDA and not user:
            device.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX):
            spans.append((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):]))
    by_name: Dict[str, list] = {}
    for start, end, name in device:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (end - start) * 1e-6
        acc[1] += 1
    busy = _union((s, e) for s, e, _ in device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps: Dict[str, float] = {}
    if busy:
        # Spans nest: sweep the gaps in time order with a stack of the
        # spans open at each gap's start; the top is the innermost.
        spans.sort()
        stack, j = [], 0
        for i in range(len(busy) - 1):
            start, end = busy[i][1], busy[i + 1][0]
            while j < len(spans) and spans[j][0] <= start:
                while stack and stack[-1][1] <= spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] <= start:
                stack.pop()
            label = stack[-1][2] if stack else "outside_spans"
            gaps[label] = gaps.get(label, 0.0) + (end - start) * 1e-6
    return dict(
        busy_s=busy_s, window_s=wall_s, ops=by_name,
        device_ops=sorted(([n, v[0]] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP],
        idle_gaps=sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:TOP],
    )


def parse_args(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell of "
                                            "obvi_slam_tpu_torch on the GPU.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    base = BENCH_DIR / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def result_line(measured: Measured, checks: List[Check], metrics: dict, device: dict,
                breakdown: Optional[dict]) -> str:
    out = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": measured.attempted,
        "failed": measured.failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)


def run(argv=None, t_start: Optional[float] = None, device: str = "cuda",
        stdout=None, files: Optional[dict] = None) -> int:
    """One run of one cell. ``device`` "cpu" and ``files`` (``bench``,
    ``workload`` and ``config`` dicts in place of the files) serve the
    benchmark's own CPU tests only: a run that measures takes the card or
    fails."""
    t_start = time.perf_counter() if t_start is None else t_start
    stdout = stdout or sys.stdout
    files = files or {}
    args = parse_args(argv)
    bench = files.get("bench") or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    workload = files.get("workload") or load_json(BENCH_DIR / "workloads"
                                                  / f"{args.workload}.json")
    config = files.get("config") or load_json(BENCH_DIR / "configs"
                                              / f"{workload['config']}.json")
    chips = cells[args.workload]["chips"]
    cache_dirs()
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
    # f32 as the configuration states it: no TF32 in matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    driver = load_module(BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                         f"driver_{workload['driver']}")
    ctx = driver.setup(workload, config, args.seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(bool(args.trace))
    measured = driver.measure(ctx, args.seconds, tracer)
    tracer.finish()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    driver.release(ctx)
    checks = driver.check(ctx, measured)

    e2e, layer = cell_metrics(bench, args.workload)
    metrics, breakdown = {}, None
    if args.trace:
        record = dict(measured.record, trace=tracer.summary, workload=args.workload)
        for m in layer:
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tracer.summary is not None:
            breakdown = {"device_ops": tracer.summary["device_ops"],
                         "idle_gaps": tracer.summary["idle_gaps"]}
    else:
        values = dict(measured.e2e, setup_s=setup_s)
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
        "count": chips,
        "memory_peak_bytes": int(peak),
    }
    if args.trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary["busy_s"]
        dev["window_s"] = tracer.summary["window_s"]
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    print(f"setup_s {setup_s} (not a check)", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(result_line(measured, checks, metrics, dev, breakdown), file=stdout)
    stdout.flush()
    return 0


def checks_of(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The readings that the cell's workload file gives a limit, as checks;
    the others go to standard error as readings only (a number with no
    limit, PERF.md says why)."""
    for name in sorted(set(readings) - set(limits)):
        print(f"reading {name} {readings[name]!r} (not compared)", file=sys.stderr)
    return [Check(name, readings[name], limits[name]) for name in sorted(limits)
            if name in readings]


def first_record(summary):
    """(cost, decrease, step norm) of a solve's first LM iteration, from the
    program's iteration records (decrease and norm 0 where not accepted)."""
    if not summary.iterations:
        return (summary.initial_cost, 0.0, 0.0)
    rec = summary.iterations[0]
    return (rec.cost, rec.cost_change, rec.step_norm)


# The program's two-phase selection parameters (TwoPhaseConfig) and the
# reference's names for them.
TWO_PHASE_KEYS = (
    ("feature_outlier_percentage", "outlier_share"),
    ("min_low_level_feature_observations", "min_feature_observations"),
    ("min_low_level_feature_observations_per_frame", "min_frame_observations"),
    ("min_object_observations", "min_object_observations"),
    ("include_visual_factors", "include_visual"),
    ("include_object_factors", "include_objects"),
    ("include_shape_priors", "include_shape_priors"),
    ("fix_objects", "fix_objects"),
    ("fix_ltm_objects", "fix_ltm_objects"),
    ("force_include_ltm_objs", "force_include_ltm_objects"),
)


def two_phase_settings(program: dict):
    """The reference's TwoPhaseSettings from the program's parameter names."""
    from benchmark.reference.lm import TwoPhaseSettings

    return TwoPhaseSettings(**{ref: program[name] for name, ref in TWO_PHASE_KEYS})
