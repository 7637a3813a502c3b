"""The banded path of obvi_slam_tpu_torch against the JAX reference at f64 on
CPU: the band layouts of the Schur plan (array-equal, fallbacks included),
the banded compute_step (kernel K3's plain version), and the dense step at
the gate where kernel K4 takes the point gram."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu_torch import compute_step, ops, synthetic_problem
from obvi_slam_tpu_torch.solver import plan as plan_mod
from torch_port_helpers import jax_problem, npy, rel_err, to_port

torch.set_num_threads(1)

jax_compute_step = jax.jit(jschur.compute_step, static_argnames=("huber", "dense_schur"))

# Sizes of tests/test_band_gram.py.
BAND_SIZES = [
    dict(n_poses=256, n_points=384, n_objects=4, obs_per_point=6, obs_per_object=6),
    dict(n_poses=256, n_points=768, n_objects=8, obs_per_point=6, obs_per_object=8),
]
BAND_IDS = ["256-384-4", "256-768-8"]


def _assert_plans_equal(ours, ref):
    assert ours._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        a, b = npy(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize(
    "size",
    [dict(n_poses=256, n_points=512, n_objects=4, obs_per_point=6, obs_per_object=6),
     dict(n_poses=256, n_points=256, n_objects=4, obs_per_point=6, obs_per_object=6)],
    ids=["256-512-4", "256-256-4"],
)
def test_band_plan_equals_jax(size):
    ours = synthetic_problem(**size, device="cpu")[4]
    ref = jax_problem(**size)[4]
    assert ref.pt_band_local_pose is not None and ref.rel_band_local_pose is not None
    assert ours.pt_band_local_pose.shape[0] == 4  # ceil(256 / 64) groups
    _assert_plans_equal(ours, ref)


FALLBACKS = [
    ("small problem", ([0, 1, 2], [0, 0, 0], 8, [], [], 4), dict(n_pose=64), (False, False)),
    ("wide span", ([0, 200, 10, 11], [0, 0, 1, 1], 8, [], [], 4), dict(n_pose=256),
     (False, False)),
    ("narrow span", ([0, 1, 10, 11], [0, 0, 1, 1], 8, [], [], 4), dict(n_pose=256),
     (True, False)),
    ("no n_pose", ([0, 1], [0, 0], 4, [], [], 4), dict(), (False, False)),
    ("wide relpose", ([0, 1], [0, 0], 4, [], [], 4),
     dict(n_pose=256, rl_before=[0, 10], rl_after=[200, 11], rl_cap=4), (True, False)),
    ("narrow relpose", ([0, 1], [0, 0], 4, [], [], 4),
     dict(n_pose=256, rl_before=[0, 10], rl_after=[1, 11], rl_cap=4), (True, True)),
    ("pinned lg caps", ([0, 1, 70, 71], [0, 0, 1, 1], 8, [3], [0], 4),
     dict(n_pose=200, rl_before=[0], rl_after=[1], rl_cap=2,
          caps={"pt_band_lg": 256, "rel_band_lg": 384}), (True, True)),
]


@pytest.mark.parametrize(
    "case,args,kw,band", FALLBACKS, ids=[c[0].replace(" ", "-") for c in FALLBACKS]
)
def test_band_plan_fallbacks_equal_jax(case, args, kw, band):
    ours = plan_mod.build_schur_plan_host(*args, **kw, device="cpu")
    ref = jschur.build_schur_plan_host(*args, **kw)
    assert (ours.pt_band_local_pose is not None, ours.rel_band_local_pose is not None) == band
    _assert_plans_equal(ours, ref)


def _weights(tables, mode):
    """All-ones weights, or 0/1 weights as a two-phase pass leaves them."""
    w = jschur.ones_weights(tables)
    if mode == "ones":
        return w
    rng = np.random.default_rng(11)
    return jschur.FactorWeights(*(np.asarray(x) * (rng.uniform(size=x.shape) > 0.15) for x in w))


def _step_pair(size, mode="ones", radius=1e4):
    state, _, cams, tables, plan, free, _, huber = jax_problem(**size)
    weights = _weights(tables, mode)
    ref = jax_compute_step(
        state, cams, tables, plan, free, weights, jnp.asarray(radius), huber, dense_schur=True
    )
    ours = compute_step(
        to_port(state), to_port(cams), to_port(tables), to_port(plan), to_port(free),
        to_port(weights), radius, to_port(huber),
    )
    return ours, ref, plan


def _assert_steps_match(ours, ref, tol):
    (d, mc, g), (d_ref, mc_ref, g_ref) = ours, ref
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(d, name), getattr(d_ref, name)) <= tol, name
    assert abs(float(mc) - float(mc_ref)) <= tol * abs(float(mc_ref))
    assert abs(float(g) - float(g_ref)) <= tol * abs(float(g_ref))


class _Spy:
    """Counts the calls of an ops wrapper and passes them on."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        inner = getattr(ops, name)

        def spy(*args):
            self.calls += 1
            return inner(*args)

        monkeypatch.setattr(ops, name, spy)


@pytest.mark.parametrize(
    "size,mode,radius",
    [(BAND_SIZES[0], "ones", 1e4), (BAND_SIZES[1], "ones", 1e4), (BAND_SIZES[0], "dropped", 3.0)],
    ids=[BAND_IDS[0], BAND_IDS[1], BAND_IDS[0] + "-dropped"],
)
def test_banded_step_matches_jax_f64(size, mode, radius, monkeypatch):
    band, syrk = _Spy(monkeypatch, "band_zbuild_gram"), _Spy(monkeypatch, "syrk_gram")
    ours, ref, plan = _step_pair(size, mode, radius)
    assert plan.pt_band_local_pose is not None
    assert (band.calls, syrk.calls) == (1, 0)
    _assert_steps_match(ours, ref, 1e-9)


def test_banded_f32_step_tracks_f64():
    """The bound of tests/test_f32_precision.py for the reference's f32 step."""
    steps = {}
    for dtype in (np.float64, np.float32):
        state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
            **BAND_SIZES[0], dtype=dtype, device="cpu"
        )
        assert plan.pt_band_local_pose is not None
        steps[dtype] = compute_step(state, cams, tables, plan, free, weights, 1e4, huber)
    (d64, mc64, _), (d32, mc32, _) = steps[np.float64], steps[np.float32]
    assert d32.poses.dtype == torch.float32
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(d32, name), getattr(d64, name)) < 5e-3, name
    assert abs(float(mc32) - float(mc64)) / abs(float(mc64)) < 5e-3


@pytest.mark.parametrize(
    "size,syrk_calls",
    [(dict(n_poses=64, n_points=1024, n_objects=8, obs_per_point=4, obs_per_object=6), 1),
     (dict(n_poses=64, n_points=768, n_objects=8, obs_per_point=4, obs_per_object=6), 0),
     (dict(n_poses=40, n_points=1024, n_objects=8, obs_per_point=4, obs_per_object=6), 0)],
    ids=["64-1024-gate", "64-768-few-points", "40-1024-no-tile"],
)
def test_dense_step_at_syrk_gate_matches_jax_f64(size, syrk_calls, monkeypatch):
    """Sizes of tests/test_syrk.py: 1024 landmark rows and 6P = 384 meet the
    reference's syrk gate; 768 rows (not >= 1024) or 6P = 240 (no 128-tile)
    do not. The K4 wrapper is reached exactly when the gate holds."""
    band, syrk = _Spy(monkeypatch, "band_zbuild_gram"), _Spy(monkeypatch, "syrk_gram")
    ours, ref, plan = _step_pair(size)
    assert plan.pt_band_local_pose is None
    assert (band.calls, syrk.calls) == (0, syrk_calls)
    _assert_steps_match(ours, ref, 1e-9)


def test_plain_step_takes_no_wrapper(monkeypatch):
    """plain=True runs both grams through their plain versions."""
    band, syrk = _Spy(monkeypatch, "band_zbuild_gram"), _Spy(monkeypatch, "syrk_gram")
    for size in (BAND_SIZES[0], dict(n_poses=64, n_points=1024, n_objects=8, obs_per_point=4)):
        problem = synthetic_problem(**size, device="cpu")
        state, _, cams, tables, plan, free, weights, huber = problem
        (d, mc, _) = compute_step(state, cams, tables, plan, free, weights, 1e4, huber, plain=True)
        (d_k, mc_k, _) = compute_step(state, cams, tables, plan, free, weights, 1e4, huber)
        assert torch.equal(d.poses, d_k.poses) and float(mc) == float(mc_k)
    assert (band.calls, syrk.calls) == (1, 1)


def test_banded_failed_factorization_zeroes_the_pose_step():
    """A negative radius makes the c-major S indefinite: the step is zeroed
    (LM then rejects it), never raised."""
    state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        **BAND_SIZES[0], device="cpu"
    )
    d, _, _ = compute_step(state, cams, tables, plan, free, weights, -1.0, huber)
    assert torch.equal(d.poses, torch.zeros_like(d.poses))
