"""The port's synthetic window, Schur plan and state conversion against the
JAX reference: equal arrays for equal seeds and index columns."""

import numpy as np
import pytest
import torch

from obvi_slam_tpu import types as jt
from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu_torch import convert
from obvi_slam_tpu_torch import compute_step, synthetic_problem
from obvi_slam_tpu_torch.solver import plan as plan_mod
from torch_port_helpers import JAX_TYPES, jax_problem, npy, to_port

torch.set_num_threads(1)

SIZES = [
    dict(n_poses=16, n_points=64, n_objects=4, seed=0),
    dict(n_poses=24, n_points=160, n_objects=4, seed=3),
    dict(n_poses=12, n_points=48, n_objects=4, obs_per_object=10, seed=4),
]
IDS = ["16-64-4", "24-160-4", "12-48-4"]


def _assert_trees_equal(ours, ref, path="problem"):
    if ref is None:
        assert ours is None, path
        return
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        assert type(ours).__name__ == type(ref).__name__, path
        assert ours._fields == ref._fields, path
        for name in ref._fields:
            _assert_trees_equal(getattr(ours, name), getattr(ref, name), f"{path}.{name}")
        return
    if isinstance(ref, (int, float)):
        assert ours == ref, path
        return
    a, b = npy(ours), np.asarray(ref)
    assert a.dtype == b.dtype, f"{path}: {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("size", SIZES, ids=IDS)
def test_synthetic_problem_equals_jax(size):
    ours = synthetic_problem(**size, device="cpu")
    ref = jax_problem(**size)
    for name, a, b in zip(
        ("state0", "state_gt", "cams", "tables", "plan", "free", "weights", "huber"), ours, ref
    ):
        _assert_trees_equal(a, b, name)


def test_float32_synthetic_problem_equals_jax():
    size = dict(n_poses=16, n_points=64, n_objects=4, seed=1, dtype=np.float32)
    ours = synthetic_problem(**size, device="cpu")
    ref = jax_problem(**size)
    for a, b in zip(ours[:4], ref[:4]):
        _assert_trees_equal(a, b)


def test_plan_with_duplicate_observations_and_pinned_caps():
    """Duplicate (pose, point) factors make factor -> pair non-injective
    (segment-sum W blocks); pinned caps are minimums."""
    rng = np.random.default_rng(3)
    rp_pose = rng.integers(0, 10, 120)
    rp_point = rng.integers(0, 30, 120)
    rp_pose[60:70], rp_point[60:70] = rp_pose[:10], rp_point[:10]
    bb_pose = rng.integers(0, 10, 20)
    bb_obj = rng.integers(0, 3, 20)
    caps = {"pt_pair": 256, "pt_cross": 1536, "ob_slot_c": 16, "pt_dest": 128}
    ours = plan_mod.build_schur_plan_host(
        rp_pose, rp_point, 130, bb_pose, bb_obj, 24, caps=caps, n_pose=10, device="cpu"
    )
    ref = jschur.build_schur_plan_host(
        rp_pose, rp_point, 130, bb_pose, bb_obj, 24, caps=caps, n_pose=10
    )
    assert ours.pt_pair_factor is None and ref.pt_pair_factor is None
    _assert_trees_equal(ours, ref, "plan")

    tables = jt.FactorTables(
        reproj=jt.make_reprojection_factors(
            rp_pose, rp_point, np.zeros(120, int), np.zeros((120, 2)), np.ones((120, 2)), 130
        ),
        bbox=jt.make_bounding_box_factors(
            bb_obj, bb_pose, np.zeros(20, int), np.zeros((20, 4)), np.zeros((20, 4, 4)), 24
        ),
        shape=None, relpose=None, ltm=None, param_prior=None,
    )
    from_tables = plan_mod.build_schur_plan(to_port(tables), caps=caps, n_pose=10, device="cpu")
    _assert_trees_equal(from_tables, ref, "plan from tables")


def test_banded_plan_is_refused():
    """A banded plan is built at any size, equal to the reference's; from 512
    poses, where the reference solves S block-tridiagonally (a solve the
    port does not have), compute_step refuses it."""
    size = dict(n_poses=512, n_points=256, n_objects=2, obs_per_object=4, seed=0)
    state, _, cams, tables, plan, free, weights, huber = synthetic_problem(**size, device="cpu")
    _assert_trees_equal(plan, jax_problem(**size)[4], "plan")
    assert plan.pt_band_local_pose is not None and plan.rel_band_local_pose is not None
    with pytest.raises(NotImplementedError, match="band solve"):
        compute_step(state, cams, tables, plan, free, weights, 1e4, huber)


def test_convert_round_trips_a_jax_problem():
    ref = jax_problem(n_poses=16, n_points=64, n_objects=4, seed=0)
    for tree in ref:
        ours = to_port(tree)
        assert type(ours).__module__.startswith("obvi_slam_tpu_torch")
        _assert_trees_equal(convert.to_numpy(ours, types=JAX_TYPES), tree)
        assert type(convert.to_numpy(ours, types=JAX_TYPES)) is type(tree)


def test_convert_casts_only_floating_leaves():
    state, _, cams, tables, *_ = jax_problem(n_poses=8, n_points=30, n_objects=2, seed=9)
    t = to_port(tables, dtype=np.float32)
    assert t.reproj.rect_obs.dtype == torch.float32
    assert t.reproj.pose_idx.dtype == torch.int32
    assert t.reproj.mask.dtype == torch.bool
    assert to_port(state, dtype=torch.float32).poses.dtype == torch.float32
