"""The port's fused solves (``solve_fused``, ``solve_two_phase_fused``: the
masked LM body ``_lm_body`` run eagerly on the CPU, as the card's CUDA
graphs replay it) at f64 on the CPU: against the JAX package's fused solves
(on a dense window, a banded 256-pose problem and an object problem), and
against the port's host loop (every termination code, non-monotonic steps,
no iterations, records on and off), and a whole session through the
port's runner forced onto the fused path (against its host loop and the JAX
runner). The object problem is the pending-object mini-BA as each package's
frontend builds it.

Tolerances: against the JAX package, the same termination and iteration
counts, the initial cost within rel 1e-10, the final cost within rel 1e-9
and the final state within rel 1e-9 (norm of the difference over the
norm), the records' accept flags equal and their costs within 1e-9 (radii,
cost changes and step norms within JAX_STEP_RTOL);
against the port's host loop, which computes the same step, the same
termination, counts and accept flags, and costs, records and final state
within rel 1e-9 (a record's cost change within 1e-9 of its cost, its step
norm within 1e-9 of the solve's largest step). Calls of the body after the
loop's end change no bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obvi_slam_tpu.solver import lm_fused as jlm
from obvi_slam_tpu.solver import two_phase as jtp
from obvi_slam_tpu.solver.lm import LMParams as JaxLMParams
from obvi_slam_tpu_torch.solver import (
    LMParams,
    TwoPhaseAux,
    TwoPhaseConfig,
    solve,
    solve_fused,
    solve_fused_jit,
    solve_two_phase,
    solve_two_phase_fused,
    solve_two_phase_jit,
)
from obvi_slam_tpu_torch.solver import lm_fused
from test_runner_e2e import ate_rmse, make_session
from test_torch_runner import _jax_frontend, _trajectory, small_config
from torch_port_helpers import jax_problem, rel_err, to_port

torch.set_num_threads(1)

RTOL = 1e-9
# Against the JAX package the records' radii, cost changes and step norms
# carry the gain ratio's cancellation (a change of ~1e-6 of the cost over
# the model's): 1e-6, where the two packages' steps differ by ~1e-13.
JAX_STEP_RTOL = 1e-6
DENSE = dict(n_poses=16, n_points=64, n_objects=4, seed=0)
# tests/test_torch_band_lm.py's banded problem (its comment says why so few
# points).
BANDED = dict(n_poses=256, n_points=384, n_objects=4, obs_per_point=6, obs_per_object=12, seed=1)


def _mini_ba_problems():
    """The object problem: the pending-object mini-BA of
    ``tests/test_torch_objects.py::test_mini_ba_alone_matches_jax`` (its
    chairs asymmetric: the yaw of symmetric ones is unobservable and its LM
    chaotic), as each package's frontend builds it (bounding-box and
    shape-prior factors, the observing poses fixed). Returns the JAX and the
    port problem as (state, None, cams, tables, plan, free, weights, huber)."""
    import obvi_slam_tpu.solver as jsolver
    from obvi_slam_tpu.solver.schur import ones_weights as jax_ones

    import obvi_slam_tpu_torch as ot
    from obvi_slam_tpu_torch import config as pcfg
    from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf
    from obvi_slam_tpu_torch.solver.schur import ones_weights
    from test_torch_objects import _pending_set
    from torch_object_helpers import object_config, port_frontend

    data, gt_poses, config, ref = _pending_set()
    targets = [i for i, p in enumerate(ref.pending) if p.object_estimate is not None]
    pg = ot.PoseGraph(data.cameras, pcfg.shape_prior_map(object_config(pcfg)))
    for i in range(len(gt_poses)):
        pg.add_frame(i, gt_poses[i])
    fe = port_frontend(pg, object_config(pcfg))
    for p in ref.pending:
        fe.pending.append(bbf.PendingObject(
            p.semantic_class, p.min_frame_id, p.max_frame_id,
            [bbf.PendingObservation(o.frame_id, o.camera_id, o.corners, o.covariance,
                                    o.confidence) for o in p.observations],
            p.observed_feats, None if p.object_estimate is None else p.object_estimate.copy(),
            p.max_confidence, p.ready_for_merge))
    seen = {}

    def recorder(key, inner):
        def solve(state, cams, tables, plan, free, params=None, huber=None, **kw):
            seen[key] = (state, None, cams, tables, plan, free, huber)
            return inner(state, cams, tables, plan, free, params=params, huber=huber, **kw)
        return solve

    host, port_solve = jsolver.solve, bbf.solve
    jsolver.solve, bbf.solve = recorder("jax", host), recorder("port", port_solve)
    try:
        del ref._run_pending_mini_ba  # the helper's stub
        ref._run_pending_mini_ba(targets)
        fe._run_pending_mini_ba(targets)
    finally:
        jsolver.solve, bbf.solve = host, port_solve
    j, p = seen["jax"], seen["port"]
    return (j[:6] + (jax_ones(j[3]), j[6]),
            p[:6] + (ones_weights(p[3], dtype=p[0].poses.dtype), p[6]))


@pytest.fixture(scope="module", params=["dense", "banded", "objects"])
def problem(request):
    if request.param == "objects":
        ref, port = _mini_ba_problems()
        return request.param, ref, port
    ref = jax_problem(**{"dense": DENSE, "banded": BANDED}[request.param])
    if request.param == "banded":
        assert ref[4].pt_band_local_pose is not None
    return request.param, ref, tuple(to_port(x) for x in ref)


def _aux(tables):
    return jtp.TwoPhaseAux(is_ltm_obj=jnp.zeros(tables.shape.obj_idx.shape[0], dtype=bool),
                           shape_live=tables.shape.mask)


def _port_aux(state, tables):
    return TwoPhaseAux(is_ltm_obj=torch.zeros(state.objects.shape[0], dtype=torch.bool),
                       shape_live=tables.shape.mask)


def _close(a, b, rtol=RTOL):
    return abs(a - b) <= rtol * max(abs(b), 1e-300)


def _assert_same_summary(ours, ref, rtol=RTOL):
    assert ours.termination == ref.termination
    assert ours.num_iterations == ref.num_iterations
    assert ours.num_successful_steps == ref.num_successful_steps
    assert ours.num_unsuccessful_steps == ref.num_unsuccessful_steps
    assert _close(ours.initial_cost, ref.initial_cost, 1e-10)
    assert _close(ours.final_cost, ref.final_cost, rtol)


def _assert_same_records(ours, ref, rtol=RTOL, step_rtol=RTOL):
    """The same accept flags; costs within rtol; radii within step_rtol, a
    cost change (a difference of two costs) within step_rtol of the cost,
    a step norm within step_rtol of the solve's largest step."""
    assert len(ours.iterations) == len(ref.iterations) == ours.num_iterations
    steps = max((r.step_norm for r in ref.iterations), default=0.0)
    for a, b in zip(ours.iterations, ref.iterations):
        assert a.iteration == b.iteration and a.accepted == b.accepted
        assert _close(a.cost, b.cost, rtol) and _close(a.radius, b.radius, step_rtol), (a, b)
        assert abs(a.cost_change - b.cost_change) <= step_rtol * b.cost, (a, b)
        assert abs(a.step_norm - b.step_norm) <= step_rtol * steps, (a, b)


def _assert_same_state(ours, ref, rtol=RTOL):
    """The reference's rows past ours are its capacity padding (the JAX
    mini-BA's buckets)."""
    for name in ("poses", "points", "objects"):
        x = getattr(ours, name)
        assert rel_err(x, np.asarray(getattr(ref, name))[: x.shape[0]]) <= rtol, name


def test_solve_fused_matches_jax(problem):
    name, ref, port = problem
    state, _, cams, tables, plan, free, weights, huber = ref
    final_ref, summary_ref = jlm.solve_fused(state, cams, tables, plan, free, weights,
                                             JaxLMParams(), huber, with_records=True)
    s, _, c, t, p, f, w, h = port
    final, summary = solve_fused(s, c, t, p, f, w, LMParams(), h, with_records=True)
    assert summary.termination == "FUNCTION_TOLERANCE" and summary.num_iterations > 3
    _assert_same_summary(summary, summary_ref)
    _assert_same_records(summary, summary_ref, step_rtol=JAX_STEP_RTOL)
    _assert_same_state(final, final_ref)


def test_two_phase_fused_matches_jax(problem):
    name, ref, port = problem
    state, _, cams, tables, plan, free, weights, huber = ref
    cfg = TwoPhaseConfig()
    final_ref, s1_ref, s2_ref = jlm.solve_two_phase_fused(
        state, cams, tables, plan, free, weights, _aux(tables), JaxLMParams(), JaxLMParams(),
        huber, jtp.TwoPhaseConfig(**cfg._asdict()))
    s, _, c, t, p, f, w, h = port
    final, s1, s2 = solve_two_phase_fused(s, c, t, p, f, w, _port_aux(s, t), LMParams(),
                                          LMParams(), h, cfg)
    _assert_same_summary(s1, s1_ref)
    _assert_same_summary(s2, s2_ref)
    assert s2.final_cost < s2.initial_cost
    assert s1.iterations == s2.iterations == []  # records off
    _assert_same_state(final, final_ref)


# Each termination code of the dense problem, the non-monotonic branch and
# a bound of 1 iteration: (LMParams overrides, expected termination).
CASES = {
    "function": (dict(), "FUNCTION_TOLERANCE"),
    "gradient": (dict(gradient_tolerance=1e12), "GRADIENT_TOLERANCE"),
    "parameter": (dict(function_tolerance=0.0, parameter_tolerance=1.0), "PARAMETER_TOLERANCE"),
    "radius": (dict(min_relative_decrease=1e9, min_trust_region_radius=1e2),
               "MIN_TRUST_REGION"),
    "max-iterations": (dict(max_num_iterations=5), "MAX_ITERATIONS"),
    "one-iteration": (dict(max_num_iterations=1), "MAX_ITERATIONS"),
    "nonmonotonic": (dict(allow_non_monotonic_steps=True, max_consecutive_nonmonotonic_steps=2,
                          function_tolerance=1e-9), None),
}


@pytest.fixture(scope="module")
def dense():
    return tuple(to_port(x) for x in jax_problem(**DENSE))


@pytest.mark.parametrize("with_records", [True, False], ids=["records", "no-records"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_fused_matches_host_loop(dense, case, with_records):
    overrides, termination = CASES[case]
    params = LMParams(**overrides)
    s, _, c, t, p, f, w, h = dense
    final, summary = solve_fused(s, c, t, p, f, w, params, h, with_records=with_records)
    final_h, summary_h = solve(s, c, t, p, f, w, params, h)
    if termination is not None:
        assert summary.termination == termination
    _assert_same_summary(summary, summary_h)
    if with_records:
        _assert_same_records(summary, summary_h)
    else:
        assert summary.iterations == []
    _assert_same_state(final, final_h)


@pytest.mark.parametrize("case", ["function", "radius", "nonmonotonic"])
def test_two_phase_fused_matches_host_loop(dense, case):
    params = LMParams(**CASES[case][0])
    s, _, c, t, p, f, w, h = dense
    aux = _port_aux(s, t)
    final, s1, s2 = solve_two_phase_fused(s, c, t, p, f, w, aux, params, LMParams(), h,
                                          TwoPhaseConfig(), with_records=True)
    final_h, s1_h, s2_h = solve_two_phase(s, c, t, p, f, w, aux, params, LMParams(), h,
                                          TwoPhaseConfig())
    for ours, ref in ((s1, s1_h), (s2, s2_h)):
        _assert_same_summary(ours, ref)
        _assert_same_records(ours, ref)
    _assert_same_state(final, final_h)


def test_zero_iterations(dense):
    """max_num_iterations == 0: the input state and its cost, as
    ``solve_fused`` returns them before any dispatch; the two-phase solve
    runs no iteration in either phase."""
    s, _, c, t, p, f, w, h = dense
    params = LMParams(max_num_iterations=0)
    final, summary = solve_fused(s, c, t, p, f, w, params, h, with_records=True)
    _, summary_h = solve(s, c, t, p, f, w, params, h)
    assert final is s
    assert summary.num_iterations == 0 and summary.iterations == []
    assert summary.termination == "MAX_ITERATIONS"
    assert summary.initial_cost == summary.final_cost == summary_h.initial_cost
    aux = _port_aux(s, t)
    final, s1, s2 = solve_two_phase_fused(s, c, t, p, f, w, aux, params, params, h,
                                          TwoPhaseConfig())
    for k in (s1, s2):
        assert k.num_iterations == 0 and k.termination == "MAX_ITERATIONS"
        assert k.initial_cost == k.final_cost
    for a, b in zip(final, s):
        assert torch.equal(a, b)


def test_jit_forms_return_the_carry(dense):
    """The ``*_jit`` forms return ``_run_lm``'s carry (term 0 -> 5) and the
    initial costs, equal to what the summaries read."""
    s, _, c, t, p, f, w, h = dense
    params = LMParams(max_num_iterations=4)
    final, init_cost = solve_fused_jit(s, c, t, p, f, w, params, h, with_records=True)
    _, summary = solve_fused(s, c, t, p, f, w, params, h, with_records=True)
    assert int(final.term) == 5 and int(final.it) == 4 == summary.num_iterations
    assert float(init_cost) == summary.initial_cost and float(final.cost) == summary.final_cost
    assert final.rec_accepted.tolist() == [r.accepted for r in summary.iterations]
    aux = _port_aux(s, t)
    f1, ic1, f2, ic2 = solve_two_phase_jit(s, c, t, p, f, w, aux, LMParams(), params, h,
                                           TwoPhaseConfig())
    _, s1, s2 = solve_two_phase_fused(s, c, t, p, f, w, aux, LMParams(), params, h,
                                      TwoPhaseConfig())
    assert (int(f1.it), int(f2.it)) == (s1.num_iterations, s2.num_iterations)
    assert (float(ic1), float(ic2)) == (s1.initial_cost, s2.initial_cost)
    assert int(f1.term) == 1 and int(f2.term) == 5


@pytest.mark.parametrize("case", ["function", "radius", "nonmonotonic", "max-iterations"])
def test_masked_calls_after_the_end_change_nothing(dense, case):
    """The body is an identity once ``running`` is False: three more calls
    leave every tensor of the carry equal bit for bit, so that a chunk of
    graph replays that runs past the end gives ``while_loop``'s result."""
    s, _, c, t, p, f, w, h = dense
    params = LMParams(**CASES[case][0])
    dyn, statics = lm_fused._split_params(params, s.poses.dtype, s.poses.device, True)

    def body(carry):
        return lm_fused._lm_body(carry, c, t, p, f, w, dyn, statics, h)

    carry = lm_fused._run_eager(lm_fused._init_carry(s, c, t, w, dyn, statics, h), body)
    assert not bool(carry.running) and int(carry.it) > 0
    after = carry
    for _ in range(3):
        after = body(after)
    for a, b in zip(lm_fused._tensors(after), lm_fused._tensors(carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bookkeeping_dtypes(dense):
    """The carry's dtypes are ``_run_lm``'s: costs and radii in the state's
    dtype, counters int32, accept records bool."""
    s, _, c, t, p, f, w, h = dense
    dyn, statics = lm_fused._split_params(LMParams(), s.poses.dtype, s.poses.device, True)
    carry = lm_fused._init_carry(s, c, t, w, dyn, statics, h)
    carry = lm_fused._lm_body(carry, c, t, p, f, w, dyn, statics, h)
    for name in ("cost", "radius", "decrease_factor", "candidate_cost", "rec_cost"):
        assert getattr(carry, name).dtype == torch.float64, name
    for name in ("it", "term", "num_success", "num_fail", "num_consecutive_nonmonotonic"):
        assert getattr(carry, name).dtype == torch.int32, name
    assert carry.rec_accepted.dtype == carry.running.dtype == torch.bool
    assert carry.rec_cost.shape == (LMParams().max_num_iterations,)


def test_ones_weights_default(dense):
    """weights=None is all-ones, as ``solve_fused``'s reference."""
    s, _, c, t, p, f, w, h = dense
    params = LMParams(max_num_iterations=3)
    a, sa = solve_fused(s, c, t, p, f, None, params, h)
    ones = type(w)(*(torch.ones_like(x) for x in w))
    b, sb = solve_fused(s, c, t, p, f, ones, params, h)
    assert sa.final_cost == sb.final_cost
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def fused_sessions():
    """tests/test_runner_e2e.py's 12-frame session (local and global BA
    windows) through the JAX runner as its TestVisualOnlyEndToEnd runs it
    (the CPU default, the host loop), and through the port's runner on the
    CPU twice: forced onto the fused path (use_fused_solver=True, each
    two-phase window one ``solve_two_phase_fused`` call) and on its CPU
    default, the host loop. The port's solve entry points are counted and
    its timers read after each run."""
    from obvi_slam_tpu import runner as jrunner
    from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph

    import obvi_slam_tpu_torch as ot
    from obvi_slam_tpu_torch import runner as prunner

    data, gt, _ = make_session()
    config = small_config()
    jax_runner = jrunner.OfflineProblemRunner(config)
    jax_pg = JaxPoseGraph(data.cameras)
    assert jax_runner.run_optimization(
        data, jax_pg, visual_frontend=_jax_frontend(jax_runner, config, data))
    runs = dict(data=data, gt=gt, jax=(jax_runner, jax_pg))
    mp = pytest.MonkeyPatch()
    try:
        for name, fused in (("fused", True), ("host", None)):
            calls = dict.fromkeys(("solve_fused", "solve_two_phase_fused", "solve",
                                   "solve_two_phase"), 0)
            for k in calls:
                mp.setattr(prunner, k, _counted(calls, k, getattr(prunner, k)))
            ours, _, _ = ot.synthetic_session()
            ot.timing.TimerRegistry.instance().reset()
            runner = ot.OfflineProblemRunner(small_config(ot.config), device="cpu",
                                             use_fused_solver=fused)
            pg = ot.PoseGraph(ours.cameras)
            assert runner.run_optimization(
                ours, pg, visual_frontend=prunner.visual_frontend_for(runner, ours))
            runs[name] = (runner, pg, set(ot.timing.TimerRegistry.instance().timers), calls)
            mp.undo()
    finally:
        mp.undo()
    return runs


def _counted(calls, name, inner):
    def call(*args, **kwargs):
        calls[name] += 1
        return inner(*args, **kwargs)
    return call


def test_session_takes_the_fused_path(fused_sessions):
    """use_fused_solver=True runs every two-phase window through
    ``solve_two_phase_fused`` and none through the host loop; the CPU
    default runs the host loop only."""
    fused, host = fused_sessions["fused"][3], fused_sessions["host"][3]
    assert fused["solve_two_phase_fused"] > 2
    assert fused["solve_two_phase"] == fused["solve"] == 0
    assert host["solve_two_phase_fused"] == host["solve_fused"] == 0
    assert host["solve_two_phase"] == fused["solve_two_phase_fused"]


def test_fused_session_matches_host_loop(fused_sessions):
    """The same solve schedule, terminations and iteration counts, costs and
    the trajectory within rel 1e-9, and the same capacity pools: the fused
    path computes the host loop's steps."""
    (fused, fpg, _, _), (host, hpg, _, _) = fused_sessions["fused"], fused_sessions["host"]
    assert len(fused.opt_log) == len(host.opt_log) > 10
    assert {r.global_ba for r in fused.opt_log} == {False, True}
    for a, b in zip(fused.opt_log, host.opt_log):
        assert (a.frame_id, a.global_ba, a.phase, a.attempt, a.termination, a.iterations) == (
            b.frame_id, b.global_ba, b.phase, b.attempt, b.termination, b.iterations)
        assert _close(a.initial_cost, b.initial_cost) and _close(a.final_cost, b.final_cost)
    n = fused_sessions["data"].max_frame_id() + 1
    traj = _trajectory(fpg, n)
    assert rel_err(traj, _trajectory(hpg, n)) <= RTOL
    assert fused._caps_pools == host._caps_pools


def test_fused_session_matches_jax(fused_sessions):
    """Against the JAX runner's CPU default: the same solve schedule and
    terminations, final costs within rel 1e-9 (atol 1e-20: the first
    window's costs are ~1e-32), and the trajectory within rtol 1e-9, atol
    1e-9. Iteration counts agree except where the JAX host loop meets the
    gradient tolerance before its first iteration: it counts 0 there, where
    its fused loop and both of the port's count 1."""
    fused, fpg = fused_sessions["fused"][:2]
    jax_runner, jax_pg = fused_sessions["jax"]
    assert len(fused.opt_log) == len(jax_runner.opt_log)
    for a, b in zip(fused.opt_log, jax_runner.opt_log):
        assert (a.frame_id, a.global_ba, a.phase, a.attempt, a.termination) == (
            b.frame_id, b.global_ba, b.phase, b.attempt, b.termination), (a, b)
        assert a.iterations == b.iterations or (
            (a.iterations, b.iterations, b.termination) == (1, 0, "GRADIENT_TOLERANCE")), (a, b)
        np.testing.assert_allclose(a.final_cost, b.final_cost, rtol=RTOL, atol=1e-20)
    n = fused_sessions["data"].max_frame_id() + 1
    np.testing.assert_allclose(_trajectory(fpg, n), _trajectory(jax_pg, n),
                               rtol=RTOL, atol=1e-9)


def test_fused_session_meets_the_e2e_gates(fused_sessions):
    """tests/test_runner_e2e.py::TestVisualOnlyEndToEnd's gates: the ATE at
    most half the odometry's and under 0.05, every frame, more than 10
    features, both phases logged; the timers under the reference's names
    (the fused path times both phases of a window under its phase-one
    solve timer, as the JAX package's fused path does)."""
    runner, pg, timers, _ = fused_sessions["fused"]
    data, gt = fused_sessions["data"], fused_sessions["gt"]
    ate_init = np.sqrt(np.mean([
        np.sum((data.initial_poses[i][:3] - gt[i, :3]) ** 2) for i in range(len(gt))
    ]))
    ate_final = ate_rmse(pg, gt)
    assert ate_final < ate_init * 0.5 and ate_final < 0.05, (ate_init, ate_final)
    assert pg.max_frame_id() == data.max_frame_id()
    assert len(pg.features) > 10
    assert {r.phase for r in runner.opt_log} == {1, 2}
    for name in ("frame_data_adder", "local_bundle_adjustment", "global_bundle_adjustment",
                 "phase_one_lba_solve_opt", "phase_one_gba_solve_opt"):
        assert name in timers, (name, timers)
