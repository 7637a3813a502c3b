"""One LM step of obvi_slam_tpu_torch (the automatic path choice, here the
dense slot-gram Schur path) against the JAX reference's
compute_step(dense_schur=True) at f64 on CPU, and the port's own f32 step
against its f64 step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu_torch import compute_step, synthetic_problem
from obvi_slam_tpu_torch.solver import band_solve
from obvi_slam_tpu_torch.solver import schur as schur_mod
from torch_port_helpers import jax_problem, rel_err, to_port

torch.set_num_threads(1)

SIZES = [dict(n_poses=16, n_points=64, n_objects=4, seed=0),
         dict(n_poses=24, n_points=160, n_objects=4, seed=3)]
IDS = ["16-64-4", "24-160-4"]
# One XLA program per shape instead of one per primitive (eager dispatch).
jax_compute_step = jax.jit(jschur.compute_step, static_argnames=("huber", "dense_schur"))


def _weights(tables, mode):
    """All-ones weights, or 0/1 weights as a two-phase pass leaves them."""
    w = jschur.ones_weights(tables)
    if mode == "ones":
        return w
    rng = np.random.default_rng(11)
    return jschur.FactorWeights(
        *(np.asarray(x) * (rng.uniform(size=x.shape) > 0.15) for x in w)
    )


@pytest.mark.parametrize("mode,radius", [("ones", 1e4), ("dropped", 3.0)])
@pytest.mark.parametrize("size", SIZES, ids=IDS)
def test_step_matches_jax_f64(size, mode, radius):
    state, _, cams, tables, plan, free, _, huber = jax_problem(**size)
    weights = _weights(tables, mode)
    d_ref, mc_ref, g_ref = jax_compute_step(
        state, cams, tables, plan, free, weights, jnp.asarray(radius), huber,
        dense_schur=True,
    )
    d, mc, g = compute_step(
        to_port(state), to_port(cams), to_port(tables), to_port(plan), to_port(free),
        to_port(weights), radius, to_port(huber),
    )
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(d, name), getattr(d_ref, name)) <= 1e-9, name
    assert abs(float(mc) - float(mc_ref)) <= 1e-9 * abs(float(mc_ref))
    assert abs(float(g) - float(g_ref)) <= 1e-9 * abs(float(g_ref))


@pytest.mark.parametrize("size", SIZES, ids=IDS)
def test_f32_step_tracks_f64(size):
    """The bound of tests/test_f32_precision.py for the reference's f32 step."""
    steps = {}
    for dtype in (np.float64, np.float32):
        state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
            **size, dtype=dtype, device="cpu"
        )
        steps[dtype] = compute_step(state, cams, tables, plan, free, weights, 1e4, huber)
    (d64, mc64, _), (d32, mc32, _) = steps[np.float64], steps[np.float32]
    assert d32.poses.dtype == torch.float32
    assert rel_err(d32.poses, d64.poses) < 5e-3
    assert rel_err(d32.points, d64.points) < 5e-3
    assert abs(float(mc32) - float(mc64)) / abs(float(mc64)) < 5e-3


def test_failed_factorization_zeroes_the_pose_step():
    """A negative radius makes S indefinite: the step is zeroed, never raised."""
    state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        n_poses=16, n_points=64, n_objects=4, device="cpu"
    )
    d, _, _ = compute_step(state, cams, tables, plan, free, weights, -1.0, huber)
    assert torch.equal(d.poses, torch.zeros_like(d.poses))


def test_unported_paths_raise(monkeypatch):
    """The paths that once raised now step: pair enumeration and
    an over-budget slot grid return finite steps; a banded 512-pose problem
    takes one band solve."""
    state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        n_poses=16, n_points=64, n_objects=4, device="cpu"
    )
    args = (state, cams, tables, plan, free, weights, 1e4, huber)
    d, mc, _ = compute_step(*args, dense_schur=False)
    assert bool(torch.isfinite(d.poses).all()) and float(mc) > 0
    calls = []
    inner = band_solve.woodbury_band_solve
    monkeypatch.setattr(band_solve, "woodbury_band_solve", lambda *a: calls.append(1) or inner(*a))
    big = synthetic_problem(n_poses=512, n_points=256, n_objects=2, device="cpu")
    d, mc, _ = compute_step(*big[:1], *big[2:7], 1e4, big[7])
    assert len(calls) == 1
    assert bool(torch.isfinite(d.poses).all()) and float(mc) > 0
    monkeypatch.setattr(schur_mod, "_SLOT_BUDGET", 1)
    d, mc, _ = compute_step(*args)
    assert bool(torch.isfinite(d.poses).all()) and float(mc) > 0
