"""Levenberg-Marquardt with Ceres trust-region semantics, and the two-phase
window solve.

Counterpart of ``obvi_slam_tpu/solver/lm_fused.py``: the same accept/reject
on relative decrease, radius update, function/gradient/parameter/radius
termination (codes 1-5, ``lm.TERMINATION_NAMES``) and non-monotonic
bookkeeping as its ``_run_lm``, run as a host loop with one scalar readback
per iteration (the step, candidate state and cost stay on the device).
"""

from __future__ import annotations

import math

import torch

from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch.solver import schur as schur_mod
from obvi_slam_tpu_torch.solver import two_phase as tp_mod
from obvi_slam_tpu_torch.solver.lm import (
    TERMINATION_NAMES,
    IterationRecord,
    LMParams,
    LMSummary,
)
from obvi_slam_tpu_torch.types import BAState


def _cost(state, cams, tables, weights, huber):
    return fac.total_cost(
        state,
        cams,
        tables,
        huber_reproj=huber.reproj,
        huber_bbox=huber.bbox,
        huber_shape=huber.shape,
        huber_relpose=huber.relpose,
        huber_ltm=huber.ltm,
        invalid_error=huber.invalid_ellipse_error,
        reproj_weight=weights.reproj,
        bbox_weight=weights.bbox,
        shape_weight=weights.shape,
        relpose_weight=weights.relpose,
        ltm_weight=weights.ltm,
    )


def _sq(state):
    return sum((x * x).sum() for x in state)


def solve(
    state: BAState,
    cams,
    tables,
    plan,
    free,
    weights=None,
    params: LMParams = LMParams(),
    huber: schur_mod.HuberParams = schur_mod.HuberParams(),
    plain: bool = False,
):
    """Run LM from ``state``; returns (final_state, LMSummary) with one
    IterationRecord per iteration. ``plain`` is passed to compute_step."""
    if weights is None:
        weights = schur_mod.ones_weights(tables, dtype=state.poses.dtype)
    cost = float(_cost(state, cams, tables, weights, huber))
    summary = LMSummary(initial_cost=cost, final_cost=cost)
    if params.max_num_iterations == 0:
        summary.termination = "MAX_ITERATIONS"
        return state, summary

    radius = params.initial_trust_region_radius
    decrease_factor = 2.0
    candidate_cost = reference_cost = cost
    acc_candidate = acc_reference = 0.0
    n_nonmonotonic = 0
    term = 0
    free_cols = [m[:, None] for m in free]
    while term == 0 and summary.num_iterations < params.max_num_iterations:
        delta, model_change, grad_max = schur_mod.compute_step(
            state, cams, tables, plan, free, weights, radius, huber, plain=plain
        )
        new_state = BAState(*(x + d * m for x, d, m in zip(state, delta, free_cols)))
        new_cost = _cost(new_state, cams, tables, weights, huber)
        # The one device -> host readback of the iteration.
        model_change, grad_max, new_cost, step2, x2 = torch.stack(
            [model_change, grad_max, new_cost, _sq(delta), _sq(state)]
        ).tolist()
        step_norm, x_norm = math.sqrt(step2), math.sqrt(x2)

        cost_change = cost - new_cost
        valid_model = model_change > 0
        rho = cost_change / max(model_change, 1e-300) if valid_model else -1.0
        relative_decrease = rho
        if params.allow_non_monotonic_steps:
            hist_rho = (reference_cost - new_cost) / max(model_change, 1e-300)
            relative_decrease = max(rho, hist_rho)
        accepted = valid_model and relative_decrease > params.min_relative_decrease

        if accepted:
            new_radius = min(
                radius / max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                params.max_trust_region_radius,
            )
            new_decrease = 2.0
        else:
            new_radius = radius / decrease_factor
            new_decrease = decrease_factor * 2.0

        if grad_max <= params.gradient_tolerance:
            term = 2
        elif accepted and abs(cost_change) <= params.function_tolerance * cost:
            term = 1
        elif accepted and step_norm <= params.parameter_tolerance * (
            x_norm + params.parameter_tolerance
        ):
            term = 3
        elif not accepted and new_radius < params.min_trust_region_radius:
            term = 4

        if params.allow_non_monotonic_steps and accepted:
            acc_candidate += cost_change
            acc_reference += cost_change
            if new_cost < candidate_cost:
                candidate_cost = new_cost
                acc_candidate = 0.0
            if cost_change >= 0:
                n_nonmonotonic = 0
                reference_cost = new_cost
                acc_reference = 0.0
            else:
                n_nonmonotonic += 1
                if n_nonmonotonic >= params.max_consecutive_nonmonotonic_steps:
                    reference_cost = candidate_cost
                    acc_reference = acc_candidate

        summary.iterations.append(IterationRecord(
            summary.num_iterations, cost, cost_change if accepted else 0.0,
            step_norm if accepted else 0.0, new_radius, accepted,
        ))
        summary.num_iterations += 1
        if accepted:
            summary.num_successful_steps += 1
            state, cost = new_state, new_cost
        else:
            summary.num_unsuccessful_steps += 1
        radius, decrease_factor = new_radius, new_decrease

    summary.final_cost = cost
    summary.termination = TERMINATION_NAMES[term or 5]
    return state, summary


def solve_two_phase(
    state, cams, tables, plan, free, weights, aux: tp_mod.TwoPhaseAux,
    params1: LMParams, params2: LMParams,
    huber: schur_mod.HuberParams, tp_cfg: tp_mod.TwoPhaseConfig,
    plain: bool = False,
):
    """One window iteration of the reference's two-phase optimization:
    phase-1 LM, outlier ranking + factor re-selection at the phase-1
    optimum, then phase-2 LM restarted from the input state. Returns
    (final_state, summary1, summary2)."""
    final1, summary1 = solve(
        state, cams, tables, plan, free, weights, params1, huber, plain=plain
    )
    res = fac.all_residuals(final1, cams, tables, huber.invalid_ellipse_error)
    weights2 = tp_mod.reweight_on_device(
        tables, weights, res["reproj"], res["bbox"], aux, tp_cfg,
        n_pose=state.poses.shape[0], n_point=state.points.shape[0],
    )
    final2, summary2 = solve(
        state, cams, tables, plan, free, weights2, params2, huber, plain=plain
    )
    return final2, summary1, summary2
