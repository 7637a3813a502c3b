"""Shared helpers of the tests that hold ``obvi_slam_tpu_torch`` against the
JAX reference package (f64 on CPU)."""

import numpy as np
import torch

from obvi_slam_tpu import types as jt
from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu.solver import two_phase as jtp
from obvi_slam_tpu.synthetic import synthetic_problem as jax_synthetic_problem
from obvi_slam_tpu_torch import convert

# Reference classes by name, for convert.to_numpy(types=...).
JAX_TYPES = {
    cls.__name__: cls
    for cls in (
        jt.BAState,
        jt.CameraBundle,
        jt.ReprojectionFactors,
        jt.BoundingBoxFactors,
        jt.ShapePriorFactors,
        jt.RelativePoseFactors,
        jt.LtmPriorFactors,
        jt.ParamPriorFactors,
        jt.FactorTables,
        jt.FreeMasks,
        jschur.SchurPlan,
        jschur.FactorWeights,
        jschur.HuberParams,
        jtp.TwoPhaseAux,
        jtp.TwoPhaseConfig,
    )
}


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_port(tree, dtype=None):
    return convert.to_torch(tree, device="cpu", dtype=dtype)


def jax_problem(n_poses, n_points, n_objects, **kw):
    return jax_synthetic_problem(
        n_poses=n_poses, n_points=n_points, n_objects=n_objects, **kw
    )


def rel_err(a, b):
    a = np.asarray(npy(a), dtype=np.float64).ravel()
    b = np.asarray(npy(b), dtype=np.float64).ravel()
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def assert_close(a, b, rtol, atol, err_msg=""):
    np.testing.assert_allclose(npy(a), npy(b), rtol=rtol, atol=atol, err_msg=err_msg)


def out_and_back_order(n_pose):
    """old pose of each new pose: the robot drives out on the old even poses
    and back over the same ground on the old odd ones (pose 0 stays 0)."""
    k = np.arange(n_pose)
    return np.where(k < n_pose // 2, 2 * k, 2 * (n_pose - 1 - k) + 1)


def out_and_back(problem):
    """A JAX ``synthetic_problem`` relabelled out and back (the twin of
    ``chip_smoke.out_and_back``): each table's pose indices, the poses and
    the free mask permuted, the plan rebuilt by the JAX package's builder.
    Landmarks are then seen from both legs, up to P - 1 poses apart: a loop
    closure. Returns (problem, old_of_new)."""
    import jax.numpy as jnp

    state0, state_gt, cams, tables, _, free, weights, huber = problem
    n_pose = state0.poses.shape[0]
    old_of_new = out_and_back_order(n_pose)
    new_of_old = np.argsort(old_of_new)

    def idx(x):
        return jnp.asarray(new_of_old[np.asarray(x)].astype(np.int32))

    def poses(s):
        return s._replace(poses=jnp.asarray(np.asarray(s.poses)[old_of_new]))

    pp = tables.param_prior
    pp_pose = np.asarray(pp.block_kind) == 0
    tables = tables._replace(
        reproj=tables.reproj._replace(pose_idx=idx(tables.reproj.pose_idx)),
        bbox=tables.bbox._replace(pose_idx=idx(tables.bbox.pose_idx)),
        relpose=tables.relpose._replace(
            before_idx=idx(tables.relpose.before_idx), after_idx=idx(tables.relpose.after_idx)),
        param_prior=pp._replace(block_idx=jnp.asarray(np.where(
            pp_pose, new_of_old[np.clip(np.asarray(pp.block_idx), 0, n_pose - 1)],
            np.asarray(pp.block_idx)).astype(np.int32))),
    )
    rl = tables.relpose
    live = np.asarray(rl.mask)
    plan = jschur.build_schur_plan(
        tables, n_pose=n_pose, rl_before=np.asarray(rl.before_idx)[live],
        rl_after=np.asarray(rl.after_idx)[live], rl_cap=rl.capacity,
    )
    free = free._replace(poses=jnp.asarray(np.asarray(free.poses)[old_of_new]))
    return (poses(state0), poses(state_gt), cams, tables, plan, free, weights, huber), old_of_new
