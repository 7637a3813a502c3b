"""Per-LM-iteration CSV logging — IterationLogger/IterationLoggerFactory
parity (``include/debugging/optimization_logger.h:29-118``).

The reference buffers per-iteration Ceres summaries per optimization type and
flushes them to ``ceres_iterations_<type>.csv`` with columns
``optimization_id, iteration_num, cost, cost_change, step_norm,
step_norm_per_param, is_successful``. Our LM solvers carry the same records
in ``LMSummary.iterations`` (solver/lm.py); this module persists them with
the reference's file names, type names and column schema so the reference's
``iteration_plotter.py``-style tooling reads them unchanged.

Type names (optimization_logger.h:95-105):
  pending_obj_est, vf_adjust, pre_pgo_track, pgo,
  lba_phase_1, lba_phase_2, gba_phase_1, gba_phase_2

This module is a copy of ``obvi_slam_tpu/optlog.py`` (standard library
only); the port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

PENDING_ESTIMATOR_TYPE = "pending_obj_est"
VF_ADJUST_TYPE = "vf_adjust"
PRE_PGO_TRACK_TYPE = "pre_pgo_track"
PGO_TYPE = "pgo"
LBA_PHASE1_TYPE = "lba_phase_1"
LBA_PHASE2_TYPE = "lba_phase_2"
GBA_PHASE1_TYPE = "gba_phase_1"
GBA_PHASE2_TYPE = "gba_phase_2"

_HEADER = (
    "optimization_id,iteration_num,cost,cost_change,step_norm,"
    "step_norm_per_param,is_successful"
)


class IterationLoggerFactory:
    """Singleton buffering per-iteration records until write_all()."""

    _instance = None

    def __init__(self):
        self.directory: str | None = None
        # type -> list of (opt_identifier, num_params, iteration records)
        self._buffers: Dict[str, List[Tuple[str, int, list]]] = {}

    @classmethod
    def instance(cls) -> "IterationLoggerFactory":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = None

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    def set_logging_directory(self, directory: str):
        self.directory = directory

    def log_iterations(self, opt_type: str, opt_identifier: str, summary, num_params: int):
        """Buffer ``summary.iterations`` (solver/lm.py IterationRecord list)."""
        if not self.enabled:
            return
        records = list(getattr(summary, "iterations", []) or [])
        if records:
            self._buffers.setdefault(opt_type, []).append(
                (opt_identifier, max(int(num_params), 1), records)
            )

    def write_all(self):
        """Flush every buffered type to ceres_iterations_<type>.csv."""
        if not self.enabled:
            return
        os.makedirs(self.directory, exist_ok=True)
        for opt_type, entries in self._buffers.items():
            path = os.path.join(self.directory, f"ceres_iterations_{opt_type}.csv")
            with open(path, "w") as f:
                f.write(_HEADER + "\n")
                for opt_id, num_params, records in entries:
                    for rec in records:
                        f.write(
                            f"{opt_id},{rec.iteration},{rec.cost},"
                            f"{rec.cost_change},{rec.step_norm},"
                            f"{rec.step_norm / num_params},"
                            f"{1 if rec.accepted else 0}\n"
                        )
        self._buffers.clear()
