"""The port's PGO pass on global-BA frames (tracking solve, PGO with the
objects, feature re-anchoring, feature-only BA) against the JAX package at
f64 on CPU: the PGO window problem, and an object session with PGO on
through both runners (see torch_object_helpers)."""

import dataclasses

import numpy as np
import pytest
import torch

from obvi_slam_tpu.pose_graph import CameraInfo as JaxCameraInfo
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.runner import generate_odom_cov as jax_odom_cov
from obvi_slam_tpu.solver import problem as jproblem
from obvi_slam_tpu.timing import TimerRegistry as JaxTimers
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch.solver import problem as pproblem
from obvi_slam_tpu_torch.timing import TimerRegistry
from test_torch_runner import _assert_trees_equal
from torch_object_helpers import (
    ASYM_DIMS,
    assert_replays_match,
    assert_same_objects,
    assert_same_schedule,
    pgo_object_config,
    run_jax_session,
    run_port_session,
    to_jax_data,
    trajectory,
)

torch.set_num_threads(1)

PGO_TIMERS = (
    "obj_only_pgo_full_process",
    "obj_only_pgo_local_track_solve",
    "obj_only_pgo_solve_pgo",
    "obj_only_pgo_opt_feat_adjust_solve",
)


@pytest.fixture(scope="module")
def sessions():
    data, gt_poses, gt_objects = ot.synthetic_object_session(dims=ASYM_DIMS)
    jax_runner, jax_pg, _, recorder = run_jax_session(
        to_jax_data(data), pgo_object_config(dims=ASYM_DIMS))
    TimerRegistry.instance().reset()
    runner, pg, _ = run_port_session(data, pgo_object_config(pcfg, ASYM_DIMS))
    return dict(data=data, gt=gt_poses, gt_objects=gt_objects, jax_runner=jax_runner,
                jax_pg=jax_pg, records=recorder.records, runner=runner, pg=pg)


def test_every_solve_replays_equal(sessions):
    """Tracking, PGO (synthesized relpose chain + objects), feature-only and
    window solves, and the mini-BAs, each on the JAX solve's inputs."""
    assert_replays_match(sessions["records"])


def test_schedule_logs_pgo_as_phase_zero(sessions):
    ours, ref = sessions["runner"].opt_log, sessions["jax_runner"].opt_log
    assert_same_schedule(ours, ref)
    assert {r.phase for r in ours} == {0, 1, 2}
    # Non-final global-BA frames run PGO instead of the visual BA.
    pgo_frames = {r.frame_id for r in ours if r.phase == 0}
    assert pgo_frames and not {r.frame_id for r in ours if r.phase == 1 and r.global_ba
                               and r.attempt == 0} & pgo_frames
    assert_same_objects(sessions["pg"], sessions["jax_pg"], values=False)


def test_timers_and_gates(sessions):
    """tests/test_pgo.py's timer names and its ATE gate; the objects as in
    tests/test_bb_frontend.py."""
    names = set(TimerRegistry.instance().timers)
    assert all(n in names for n in PGO_TIMERS), names
    assert all(n in JaxTimers.instance().timers for n in PGO_TIMERS)
    gt, data = sessions["gt"], sessions["data"]
    n = len(gt)
    ate_init = np.sqrt(np.mean([np.sum((data.initial_poses[i][:3] - gt[i, :3]) ** 2)
                                for i in range(n)]))
    for pg in (sessions["pg"], sessions["jax_pg"]):
        ate = np.sqrt(np.mean(np.sum((trajectory(pg, n)[:, :3] - gt[:, :3]) ** 2, 1)))
        assert ate < 0.06 and ate < ate_init * 1.5, (ate, ate_init)
        assert len(pg.objects) == 2
        for node in pg.objects.values():
            assert min(np.linalg.norm(node.ellipsoid[:3] - g[:3])
                       for g in sessions["gt_objects"]) < 0.5


def test_pgo_problem_equals_jax(sessions):
    """The PGO window problem (visual factors off, the synthesized relpose
    chain with its own Huber delta) built by both packages from the same
    pose graph at the same caps: equal arrays."""
    pg = sessions["pg"]
    jpg = JaxPoseGraph.from_state(
        pg.get_state(), {c: JaxCameraInfo(**dataclasses.asdict(v))
                         for c, v in pg.cameras.items()})
    config = sessions["runner"].config
    n = pg.max_frame_id()
    chain = []
    for f in range(1, n + 1):
        b, a = pg.get_robot_pose(f - 1), pg.get_robot_pose(f)
        rel = np.concatenate([a[:3] - b[:3], a[3:] - b[3:]])
        chain.append((f - 1, f, rel, jax_odom_cov(rel, config.pgo_solver_params
                                                  .relative_pose_cov_params)))
    scope = dataclasses.replace(
        sessions["runner"]._scope(0, n), include_visual_factors=False,
        poses_prior_to_window_to_keep_constant=1)
    caps = dict(sessions["runner"].caps_pool("pgo"))
    ours = pproblem.build_problem(
        pg, scope, config.object_visual_pose_graph_residual_params, caps=caps,
        synthesized_relpose=chain, relpose_huber_override=5.0, device="cpu")
    ref = jproblem.build_problem(
        jpg, jproblem.Scope(**dataclasses.asdict(scope)),
        sessions["jax_runner"].config.object_visual_pose_graph_residual_params, caps=caps,
        synthesized_relpose=chain, relpose_huber_override=5.0)
    assert ours.huber.relpose == ref.huber.relpose == 5.0
    assert int(ours.tables.relpose.mask.sum()) == n
    for name in ("state", "cams", "tables", "plan", "free", "weights", "aux", "huber"):
        _assert_trees_equal(getattr(ours, name), getattr(ref, name), name)
