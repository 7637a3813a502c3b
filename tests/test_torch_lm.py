"""The port's LM loop and two-phase window solve against the JAX reference's
fused solvers at f64 on CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obvi_slam_tpu import factors as jfac
from obvi_slam_tpu.solver import lm_fused as jlm
from obvi_slam_tpu.solver import two_phase as jtp
from obvi_slam_tpu.solver.lm import LMParams as JaxLMParams
from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch.solver import (
    LMParams,
    TwoPhaseConfig,
    reweight_on_device,
    solve,
    solve_two_phase,
)
from obvi_slam_tpu_torch.solver import two_phase as tp_mod
from torch_port_helpers import jax_problem, npy, rel_err, to_port

torch.set_num_threads(1)

SIZE = dict(n_poses=16, n_points=64, n_objects=4, seed=0)


def _port_problem(ref):
    return tuple(to_port(x) for x in ref)


def _assert_same_summary(ours, ref):
    assert ours.num_iterations == ref.num_iterations
    assert ours.termination == ref.termination
    assert ours.num_successful_steps == ref.num_successful_steps
    assert abs(ours.initial_cost - ref.initial_cost) <= 1e-10 * ref.initial_cost
    assert abs(ours.final_cost - ref.final_cost) <= 1e-8 * ref.final_cost


@pytest.mark.parametrize(
    "params",
    [dict(), dict(allow_non_monotonic_steps=True, max_num_iterations=12),
     dict(max_num_iterations=0)],
    ids=["defaults", "nonmonotonic", "zero-iterations"],
)
def test_solve_matches_fused_lm(params):
    ref = jax_problem(**SIZE)
    state, _, cams, tables, plan, free, weights, huber = ref
    final_ref, summary_ref = jlm.solve_fused(
        state, cams, tables, plan, free, weights, JaxLMParams(**params), huber
    )
    s, _, c, t, p, f, w, h = _port_problem(ref)
    final, summary = solve(s, c, t, p, f, w, LMParams(**params), h)
    _assert_same_summary(summary, summary_ref)
    assert len(summary.iterations) == summary.num_iterations
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(final, name), getattr(final_ref, name)) <= 1e-7


def _aux_and_config(tables):
    n_obj = tables.shape.obj_idx.shape[0]
    cfg = TwoPhaseConfig()
    jax_aux = jtp.TwoPhaseAux(
        is_ltm_obj=jnp.zeros(n_obj, dtype=bool), shape_live=tables.shape.mask
    )
    return jax_aux, jtp.TwoPhaseConfig(**cfg._asdict()), cfg


def test_two_phase_matches_fused_two_phase():
    ref = jax_problem(**SIZE)
    state, _, cams, tables, plan, free, weights, huber = ref
    jax_aux, jax_cfg, cfg = _aux_and_config(tables)
    params = JaxLMParams()
    final_ref, s1_ref, s2_ref = jlm.solve_two_phase_fused(
        state, cams, tables, plan, free, weights, jax_aux, params, params, huber, jax_cfg
    )
    s, _, c, t, p, f, w, h = _port_problem(ref)
    final, s1, s2 = solve_two_phase(
        s, c, t, p, f, w, to_port(jax_aux), LMParams(), LMParams(), h, cfg
    )
    _assert_same_summary(s1, s1_ref)
    _assert_same_summary(s2, s2_ref)
    assert s2.final_cost < s2.initial_cost
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(final, name), getattr(final_ref, name)) <= 1e-7

    # The phase-2 weights each package derives from its own phase-1 optimum.
    n_pose, n_point = state.poses.shape[0], state.points.shape[0]
    phase1_ref, _ = jlm.solve_fused(state, cams, tables, plan, free, weights, params, huber)
    res = jfac.all_residuals(phase1_ref, cams, tables)
    w2_ref = jtp.reweight_on_device(
        tables, weights, res["reproj"], res["bbox"], jax_aux, jax_cfg, n_pose, n_point
    )
    phase1, _ = solve(s, c, t, p, f, w, LMParams(), h)
    res = fac.all_residuals(phase1, c, t)
    w2 = reweight_on_device(t, w, res["reproj"], res["bbox"], to_port(jax_aux), cfg, n_pose, n_point)
    for name in ("reproj", "bbox", "shape", "relpose", "ltm"):
        np.testing.assert_array_equal(npy(getattr(w2, name)), np.asarray(getattr(w2_ref, name)), name)


@pytest.mark.parametrize("per_frame", [50, 0], ids=["starved-frames", "no-relpose"])
def test_phase_two_weights_equal_jax(per_frame):
    """Same residuals in -> the same phase-2 weights out, bit for bit."""
    ref = jax_problem(**SIZE)
    state, _, cams, tables, plan, free, weights, huber = ref
    jax_aux, jax_cfg, cfg = _aux_and_config(tables)
    cfg = cfg._replace(min_low_level_feature_observations_per_frame=per_frame)
    jax_cfg = jax_cfg._replace(min_low_level_feature_observations_per_frame=per_frame)
    rng = np.random.default_rng(4)
    state = state._replace(poses=state.poses + rng.normal(size=state.poses.shape) * 0.01)
    res = jfac.all_residuals(state, cams, tables)
    n_pose, n_point = state.poses.shape[0], state.points.shape[0]
    w_ref = jtp.reweight_on_device(
        tables, weights, res["reproj"], res["bbox"], jax_aux, jax_cfg, n_pose, n_point
    )
    w = reweight_on_device(
        to_port(tables), to_port(weights), to_port(res["reproj"]), to_port(res["bbox"]),
        to_port(jax_aux), cfg, n_pose, n_point,
    )
    for name in ("reproj", "bbox", "shape", "relpose", "ltm"):
        np.testing.assert_array_equal(npy(getattr(w, name)), np.asarray(getattr(w_ref, name)), name)
    assert npy(w.reproj).sum() < npy(weights.reproj).sum()


def test_outlier_mask_matches_numpy_ranking():
    rng = np.random.default_rng(0)
    sq = rng.uniform(size=200).astype(np.float32)
    live_np = rng.uniform(size=200) > 0.3
    pct = 0.12
    live_idx = np.nonzero(live_np)[0]
    n_out = int(len(live_idx) * pct)
    worst = set(live_idx[np.argsort(-sq[live_idx])[:n_out]].tolist())
    mask = tp_mod._outlier_mask(torch.from_numpy(sq), torch.from_numpy(live_np), pct)
    assert set(np.nonzero(npy(mask))[0].tolist()) == worst


def test_outlier_count_and_ties_match_jax():
    """floor(f32(n_live) * f32(pct)) at every live count, with tied keys."""
    rng = np.random.default_rng(1)
    sq = np.round(rng.uniform(size=120), 1)  # many ties
    for pct in (0.1, 0.07, 0.3):
        for n_live in range(0, 121, 7):
            live = np.zeros(120, bool)
            live[rng.permutation(120)[:n_live]] = True
            ours = tp_mod._outlier_mask(torch.from_numpy(sq), torch.from_numpy(live), pct)
            ref = jtp._outlier_mask(jnp.asarray(sq), jnp.asarray(live), pct)
            np.testing.assert_array_equal(npy(ours), np.asarray(ref))

