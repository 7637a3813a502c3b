"""The port's two-phase solve on a banded 256-pose problem against the JAX
reference's fused two-phase solve at f64 on CPU: termination, iteration
counts and costs of both phases, and the final state."""

import torch

import jax.numpy as jnp

from obvi_slam_tpu.solver import lm_fused as jlm
from obvi_slam_tpu.solver import two_phase as jtp
from obvi_slam_tpu.solver.lm import LMParams as JaxLMParams
from obvi_slam_tpu_torch.solver import LMParams, TwoPhaseConfig, solve_two_phase
from torch_port_helpers import jax_problem, rel_err, to_port

torch.set_num_threads(1)

# Few points keep the JAX compile short; 12 views per object keep the
# objects well conditioned, so that the 1e-13 step differences of the two
# packages do not grow into different accept/reject decisions (at 256
# points and 6 views per object they do, after ~40 iterations).
SIZE = dict(n_poses=256, n_points=384, n_objects=4, obs_per_point=6, obs_per_object=12, seed=1)


def test_banded_two_phase_matches_fused_two_phase():
    ref = jax_problem(**SIZE)
    state, _, cams, tables, plan, free, weights, huber = ref
    assert plan.pt_band_local_pose is not None and plan.rel_band_local_pose is not None
    cfg = TwoPhaseConfig()
    jax_aux = jtp.TwoPhaseAux(
        is_ltm_obj=jnp.zeros(tables.shape.obj_idx.shape[0], dtype=bool),
        shape_live=tables.shape.mask,
    )
    final_ref, s1_ref, s2_ref = jlm.solve_two_phase_fused(
        state, cams, tables, plan, free, weights, jax_aux, JaxLMParams(), JaxLMParams(), huber,
        jtp.TwoPhaseConfig(**cfg._asdict()),
    )
    s, _, c, t, p, f, w, h = (to_port(x) for x in ref)
    final, s1, s2 = solve_two_phase(
        s, c, t, p, f, w, to_port(jax_aux), LMParams(), LMParams(), h, cfg
    )
    for ours, theirs in ((s1, s1_ref), (s2, s2_ref)):
        assert ours.num_iterations == theirs.num_iterations
        assert ours.num_successful_steps == theirs.num_successful_steps
        assert ours.termination == theirs.termination
        assert abs(ours.initial_cost - theirs.initial_cost) <= 1e-10 * theirs.initial_cost
        assert abs(ours.final_cost - theirs.final_cost) <= 1e-8 * theirs.final_cost
    assert s2.final_cost < s2.initial_cost
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(final, name), getattr(final_ref, name)) <= 1e-7, name
