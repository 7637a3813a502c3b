"""Levenberg-Marquardt parameters, summaries and termination names.

Counterpart of ``obvi_slam_tpu/solver/lm.py`` (its types) and the
termination codes of ``lm_fused.py``; the loop itself is in ``lm_fused``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

TERMINATION_NAMES = {
    1: "FUNCTION_TOLERANCE",
    2: "GRADIENT_TOLERANCE",
    3: "PARAMETER_TOLERANCE",
    4: "MIN_TRUST_REGION",
    5: "MAX_ITERATIONS",
}


@dataclass(frozen=True)
class LMParams:
    """Mirror of the reference's OptimizationSolverParams."""

    max_num_iterations: int = 100
    allow_non_monotonic_steps: bool = False
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    max_consecutive_nonmonotonic_steps: int = 5


class IterationRecord(NamedTuple):
    iteration: int
    cost: float
    cost_change: float
    step_norm: float
    radius: float
    accepted: bool


@dataclass
class LMSummary:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    num_iterations: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    termination: str = "NO_CONVERGENCE"
    iterations: List[IterationRecord] = field(default_factory=list)
