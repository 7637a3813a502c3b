"""Analytic FLOP model of one LM iteration: counterpart of
``obvi_slam_tpu/flops.py``.

``lm_iteration_flops`` counts, per phase of one ``compute_step`` plus the
cost evaluation of the stepped state, the f32 operations (multiplies and
adds) of the reference's model of the step, from the factor tables'
capacities and the Schur plan's shapes. The counts are that model's:
padded shapes and the one-hot z build of the reference's XLA step, not the
operations of the port's compacted kernels (K3 and K4 multiply only the
rows that touch each output tile). ``speed_of_light_table`` divides them by
one peak, the H100 SXM's 67 TFLOP/s of f32 on the CUDA cores (TF32 stays
off), and, given a measured iteration time, reports the modelled fraction
of it. A roofline of the card's own work (bytes and operations of the
kernels as launched) is a benchmark's job, not this model's.

The reference's MXU pass arguments (``gram_precision``, ``split_gram``,
``value_passes``) and its ``flops_bf16_equiv`` model a TPU's bf16 passes
and are not ported.
"""

from __future__ import annotations

from typing import Dict

# H100 SXM, f32 on the CUDA cores (no TF32).
PEAK_F32_FLOPS = 67e12


def lm_iteration_flops(tables, plan, n_pose, n_point, n_obj) -> Dict[str, Dict[str, float]]:
    """Per-phase FLOP model of one compute_step + cost evaluation:
    {phase: {"flops_f32", "unit"}}, the reference's phases and counts."""
    F_rp = int(tables.reproj.capacity)
    F_bb = int(tables.bbox.capacity)
    F_sh = int(tables.shape.capacity)
    F_rl = int(tables.relpose.capacity)
    F_lt = int(tables.ltm.capacity)
    Lp, Cp = (int(s) for s in plan.pt_slot_gather.shape)
    Lo, Co = (int(s) for s in plan.ob_slot_gather.shape)
    d6 = 6 * n_pose

    phases: Dict[str, Dict[str, float]] = {}

    def phase(name, f32):
        phases[name] = {"flops_f32": float(f32), "unit": "flop"}

    # Residual + Jacobian evaluation; per-factor counts of the analytic
    # chains (conservative estimates).
    resjac = 560 * F_rp + 2400 * F_bb + 60 * F_sh + 700 * F_rl + 120 * F_lt
    phase("residual_jacobian_eval", resjac)

    # Block H/b accumulation (outer products + segment sums).
    hb = F_rp * (2 * (36 + 9 + 18) + 18) + F_bb * (2 * (36 + 49 + 42) + 22) \
        + F_sh * 2 * 49 + F_rl * 2 * (2 * 36 + 36) + F_lt * 2 * 49
    phase("hessian_block_accumulation", hb)

    # Batched small-block Cholesky/inverses.
    phase("landmark_block_inverses", n_point * 120 + n_obj * 1000 + n_pose * 600)

    # One-hot z build; the banded layout shrinks the point one-hot to the
    # 128-wide local window.
    banded = getattr(plan, "pt_band_local_pose", None) is not None
    pt_width = 2 * 64 if banded else n_pose
    phase("schur_z_build", 2.0 * Lp * Cp * pt_width * 18 + 2.0 * Lo * Co * n_pose * 42)

    # Schur grams (S assembly). With the band layout the point gram runs as
    # G batched (768, Lg*3, 768) group grams instead of one (6P, 3Lp, 6P).
    pt_gram_width = 6 * pt_width
    rel_banded = getattr(plan, "rel_band_local_pose", None) is not None
    rel_gram_width = 6 * (2 * 64) if (banded and rel_banded) else d6
    phase("schur_gram", (
        2.0 * pt_gram_width * pt_gram_width * (Lp * 3)  # point gram
        + 2.0 * d6 * d6 * (Lo * 7)  # object gram
        + 2.0 * rel_gram_width * rel_gram_width * (6 * (F_rl + n_pose))
    ))

    # Reduced RHS + back-substitution coupling contractions.
    phase("reduced_rhs_backsub", 2.0 * (Lp * 3 * pt_gram_width + Lo * 7 * d6) * 2)

    # Dense Cholesky of S + two triangular solves + refinement matvec.
    phase("reduced_cholesky_solve", d6**3 / 3.0 + 4.0 * d6 * d6 + 2.0 * d6 * d6)

    # Cost evaluation of the stepped state (residuals only).
    phase("cost_evaluation", 0.35 * resjac)
    return phases


def speed_of_light_table(phases: Dict[str, Dict[str, float]], measured_iter_s: float = None
                         ) -> Dict:
    """Each phase's time at ``PEAK_F32_FLOPS``; with a measured iteration
    time, the modelled fraction of it (``sol_fraction``)."""
    out = {"phases": {}, "peak_f32_flops": PEAK_F32_FLOPS}
    total_f32 = 0.0
    for name, ph in phases.items():
        total_f32 += ph["flops_f32"]
        out["phases"][name] = {"flops_f32": ph["flops_f32"],
                               "sol_us": ph["flops_f32"] / PEAK_F32_FLOPS * 1e6}
    out["total_flops_f32"] = total_f32
    out["total_sol_us"] = total_f32 / PEAK_F32_FLOPS * 1e6
    if measured_iter_s is not None and measured_iter_s > 0:
        out["measured_iter_us"] = measured_iter_s * 1e6
        out["sol_fraction"] = total_f32 / PEAK_F32_FLOPS / measured_iter_s
    return out
