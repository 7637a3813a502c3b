"""Cumulative phase timers, which are also the port's spans.

Equivalent of the reference's RAII ``CumulativeFunctionTimer`` sites
(amrl_shared_lib, names in ``include/analysis/cumulative_timer_constants.h``)
so the timing breakdown is reported with the same phase names as
``timing_analysis.py`` expects (frame_data_adder, local/global BA build/solve
phase 1/2, PGO, LTM extraction, ...).

Each ``timer`` is also a span. It adds its time to its name's cumulative
total and count, as the reference's timer does; it knows its parent, the
span open around it on the stack of open spans; and it carries
the frame id of the session (``set_frame``: the runner sets it as it adds a
frame and as it optimizes one; a span keeps the id current when it opens).
While a ``torch.profiler`` is recording, a span also opens a profiler range
``obvi/<name>`` with its frame id as the keyword ``frame`` (shown in a trace
that records shapes), so that it lies on the profiler's clock beside the
device's kernels. With no profiler recording, a span costs one check of the
profiler's state and the stack's push and pop beyond the timer.
``TimerRegistry.record_spans`` keeps every closed span in memory (name,
parent, frame, start and end on ``time.perf_counter``).

The port's own span names, beside the reference's, nest inside them:
``frame_pose_add``, ``visual_frontend_add_obs`` and ``bb_frontend_hook``
(``runner.add_frame_data``), ``window_ba_write_back`` (the window BA's
snapshot, write-back and jump check), ``problem_build_assemble``,
``problem_build_plan`` and ``problem_build_upload`` (every
``solver.problem.build_problem``; the upload also in the mini-BA's build),
``mini_ba_build`` and ``mini_ba_solve`` (the pending-object mini-BA),
``fused_graph_entry`` and ``fused_capture``
(``solver.lm_fused``) and ``host_wait_on_device`` (``HOST_WAIT``: every
blocking read of device memory by the host).

The reference's part of this module is a copy of ``obvi_slam_tpu/timing.py``;
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

# The span of a blocking read of device memory by the host.
HOST_WAIT = "host_wait_on_device"
# Prefix of the spans' profiler ranges.
PROFILER_PREFIX = "obvi/"

_profiler_enabled = torch._C._autograd._profiler_enabled
# A profiler range that records keyword values (the frame id) and costs ~2
# us; torch.profiler.record_function drops its ``args`` string from the
# trace and costs ~13 us. Its constructor aborts the process on arguments
# of another type: it gets a list and a dict only.
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class CumulativeTimer:
    def __init__(self, name: str):
        self.name = name
        self.total_time = 0.0
        self.invocations = 0

    @property
    def mean(self):
        return self.total_time / self.invocations if self.invocations else 0.0


class Span(NamedTuple):
    """One closed span: its timer's name, the name of the span open around
    it (None at the top), the frame id when it opened, and its start and
    end on ``time.perf_counter``."""

    name: str
    parent: Optional[str]
    frame: Optional[int]
    start_s: float
    end_s: float


class TimerRegistry:
    """CumulativeTimerFactory analog (cumulative_timer_factory.h)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.timers: Dict[str, CumulativeTimer] = {}
        self.enabled = True
        self.frame_id: Optional[int] = None
        # Closed spans, while ``record_spans`` is on.
        self.spans: Optional[List[Span]] = None
        # Names of the open spans, outermost first (the runner is one thread).
        self.open_spans: List[str] = []

    @classmethod
    def instance(cls) -> "TimerRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def get_or_create(self, name: str) -> CumulativeTimer:
        if name not in self.timers:
            self.timers[name] = CumulativeTimer(name)
        return self.timers[name]

    def record_spans(self, on: bool = True):
        """Keeps every span closed from now on in ``spans`` (a new list),
        or stops keeping them."""
        self.spans = [] if on else None

    def reset(self):
        self.timers.clear()
        self.frame_id = None
        if self.spans is not None:
            self.spans = []

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": t.total_time,
                "invocations": t.invocations,
                "mean_s": t.mean,
            }
            for name, t in sorted(self.timers.items())
        }

    def report(self) -> str:
        lines = ["--- cumulative timers ---"]
        for name, t in sorted(
            self.timers.items(), key=lambda kv: -kv[1].total_time
        ):
            lines.append(
                f"{name:50s} total={t.total_time:9.3f}s n={t.invocations:6d} mean={t.mean * 1e3:9.2f}ms"
            )
        return "\n".join(lines)


def set_frame(frame_id: int):
    """The frame id that spans opened from now on carry."""
    TimerRegistry.instance().frame_id = int(frame_id)


def _profiler_range(name: str, frame: Optional[int]):
    """An entered profiler range ``obvi/<name>`` carrying ``frame``."""
    mark = _RecordFunctionFast(PROFILER_PREFIX + name, [],
                               {} if frame is None else {"frame": frame})
    mark.__enter__()
    return mark


class timer:
    """``with timer(name):`` times the block under ``name`` and is a span
    (see the module docstring)."""

    __slots__ = ("name", "_reg", "_timer", "_parent", "_frame", "_mark", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        reg = self._reg = TimerRegistry.instance()
        if not reg.enabled:
            self._timer = None
            return self
        self._timer = reg.get_or_create(self.name)
        stack = reg.open_spans
        self._parent = stack[-1] if stack else None
        self._frame = reg.frame_id
        self._mark = _profiler_range(self.name, self._frame) if _profiler_enabled() else None
        stack.append(self.name)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._timer is None:
            return False
        end = time.perf_counter()
        reg = self._reg
        reg.open_spans.pop()
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        self._timer.total_time += end - self._start
        self._timer.invocations += 1
        if reg.spans is not None:
            reg.spans.append(Span(self.name, self._parent, self._frame, self._start, end))
        return False
