"""Cumulative phase timers.

Equivalent of the reference's RAII ``CumulativeFunctionTimer`` sites
(amrl_shared_lib, names in ``include/analysis/cumulative_timer_constants.h``)
so the timing breakdown is reported with the same phase names as
``timing_analysis.py`` expects (frame_data_adder, local/global BA build/solve
phase 1/2, PGO, LTM extraction, ...).

This module is a copy of ``obvi_slam_tpu/timing.py`` (numpy
only); the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


class CumulativeTimer:
    def __init__(self, name: str):
        self.name = name
        self.total_time = 0.0
        self.invocations = 0

    @property
    def mean(self):
        return self.total_time / self.invocations if self.invocations else 0.0


class TimerRegistry:
    """CumulativeTimerFactory analog (cumulative_timer_factory.h)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.timers: Dict[str, CumulativeTimer] = {}
        self.enabled = True

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

    def reset(self):
        self.timers.clear()

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


@contextlib.contextmanager
def timer(name: str):
    reg = TimerRegistry.instance()
    if not reg.enabled:
        yield
        return
    t = reg.get_or_create(name)
    start = time.perf_counter()
    try:
        yield
    finally:
        t.total_time += time.perf_counter() - start
        t.invocations += 1
