"""The block-tridiagonal + Woodbury reduced solve of obvi_slam_tpu_torch
(``solver/band_solve.py``) and the band-solve branch of its compute_step,
against the JAX package at f64 on CPU and against dense numpy solves."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from obvi_slam_tpu.solver import band_solve as jbs
from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu_torch import compute_step, synthetic_problem
from obvi_slam_tpu_torch.solver import band_solve as bs
from obvi_slam_tpu_torch.solver import schur as schur_mod
from torch_port_helpers import jax_problem, npy, rel_err, to_port

torch.set_num_threads(1)

NBS = [2, 3, 5, 8, 16]
M = 8
jax_compute_step = jax.jit(jschur.compute_step, static_argnames=("huber", "dense_schur"))


def _random_block_tridiag(nb, m, seed=0):
    """Diagonally dominant PD tiles, as tests/test_band_solve.py builds them,
    and the dense matrix."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(nb - 1, m, m)) * 0.3
    d = []
    for _ in range(nb):
        q = rng.normal(size=(m, m))
        d.append(q @ q.T + m * np.eye(m))
    d = np.stack(d)
    dense = np.zeros((nb * m, nb * m))
    for i in range(nb):
        dense[i * m:(i + 1) * m, i * m:(i + 1) * m] = d[i]
    for i in range(nb - 1):
        dense[(i + 1) * m:(i + 2) * m, i * m:(i + 1) * m] = e[i]
        dense[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = e[i].T
    return d, e, dense


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(ours, ref, dense_ref):
    np.testing.assert_allclose(npy(ours), np.asarray(ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(npy(ours), dense_ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("nb", NBS)
def test_block_tridiag_cholesky_and_solve_match_jax(nb):
    d, e, dense = _random_block_tridiag(nb, M, seed=nb)
    rhs = np.random.default_rng(nb + 1).normal(size=(nb, M, 3))
    l_d, l_e, ok = bs.block_tridiag_cholesky(_t(d), _t(e))
    jl_d, jl_e = jbs.block_tridiag_cholesky(jnp.asarray(d), jnp.asarray(e))
    assert bool(ok)
    np.testing.assert_allclose(npy(l_d), np.asarray(jl_d), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(npy(l_e), np.asarray(jl_e), rtol=1e-10, atol=1e-12)
    x = bs.block_tridiag_solve(l_d, l_e, _t(rhs))
    x_ref = jbs.block_tridiag_solve(jl_d, jl_e, jnp.asarray(rhs))
    _close(x, x_ref, np.linalg.solve(dense, rhs.reshape(nb * M, 3)).reshape(nb, M, 3))


@pytest.mark.parametrize("nb", NBS)
def test_cyclic_reduction_matches_jax(nb):
    d, e, dense = _random_block_tridiag(nb, M, seed=10 + nb)
    rhs = np.random.default_rng(nb).normal(size=(nb, M, 3))
    factors = bs.cr_factor(_t(d), _t(e))
    assert bool(factors[2])
    x = bs.cr_solve(factors, _t(rhs))
    x_ref = jbs.cr_solve(jbs.cr_factor(jnp.asarray(d), jnp.asarray(e)), jnp.asarray(rhs))
    _close(x, x_ref, np.linalg.solve(dense, rhs.reshape(nb * M, 3)).reshape(nb, M, 3))


def test_block_tridiag_matvec_matches_jax():
    nb = 5
    d, e, dense = _random_block_tridiag(nb, M, seed=3)
    x = np.random.default_rng(4).normal(size=(nb, M, 2))
    out = bs.block_tridiag_matvec(_t(d), _t(e), _t(x))
    ref = jbs.block_tridiag_matvec(jnp.asarray(d), jnp.asarray(e), jnp.asarray(x))
    _close(out, ref, (dense @ x.reshape(nb * M, 2)).reshape(nb, M, 2))


@pytest.mark.parametrize("rz", [0, 10])
@pytest.mark.parametrize("path,nb", [("cr", 8), ("cr", 5), ("scan", 5), ("scan", 16)])
def test_woodbury_band_solve_matches_jax(path, nb, rz, monkeypatch):
    d, e, dense = _random_block_tridiag(nb, M, seed=40 + nb + rz)
    rng = np.random.default_rng(5)
    z = rng.normal(size=(rz, nb * M)) * 0.2  # keeps S = B - Z^T Z PD
    s = dense - z.T @ z
    assert np.linalg.eigvalsh(s).min() > 0
    rhs = rng.normal(size=nb * M)
    gate = "on" if path == "cr" else "off"
    monkeypatch.setattr(bs, "_BAND_CR", gate)
    monkeypatch.setattr(jbs, "_BAND_CR", gate)
    calls = []
    monkeypatch.setattr(bs, "cr_factor", lambda *a: calls.append(1) or _cr_factor(*a))
    x, ok = bs.woodbury_band_solve(_t(d), _t(e), _t(z), _t(rhs))
    assert bool(ok) and len(calls) == (path == "cr")
    x_ref = jbs.woodbury_band_solve(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(z), jnp.asarray(rhs)
    )
    _close(x, x_ref, np.linalg.solve(s, rhs))


_cr_factor = bs.cr_factor


def test_auto_gates_match_jax(monkeypatch):
    """The reference's defaults: CR from 8 tiles, the band solve from 512 poses."""
    for nb in (2, 7, 8, 16):
        assert bs._use_cyclic_reduction(nb) == jbs._use_cyclic_reduction(nb)
    for n_pose in (256, 511, 512, 1024):
        assert schur_mod._use_band_solve(n_pose) == jschur._use_band_solve(n_pose)
    monkeypatch.setattr(schur_mod, "_BAND_SOLVE", "off")
    assert not schur_mod._use_band_solve(4096)
    monkeypatch.setattr(bs, "_BAND_CR", "off")
    assert not bs._use_cyclic_reduction(64)


@pytest.mark.parametrize("path", ["cr", "scan"])
@pytest.mark.parametrize("where", ["tile", "woodbury"])
def test_non_pd_system_reports_failure(path, where, monkeypatch):
    """A non-PD tile (or an object term that makes S indefinite) fails a
    factorization: the flag is False and nothing raises."""
    nb = 8
    d, e, dense = _random_block_tridiag(nb, M, seed=2)
    z = np.zeros((3, nb * M))
    if where == "tile":
        d[5] = -d[5]
    else:
        z[0, :] = 3.0  # Z^T Z dominates B: C = I - Z B^-1 Z^T is not PD
    monkeypatch.setattr(bs, "_BAND_CR", "on" if path == "cr" else "off")
    _, ok = bs.woodbury_band_solve(_t(d), _t(e), _t(z), _t(np.ones(nb * M)))
    assert not bool(ok)


# ---- compute_step with the band solve -----------------------------------

SIZE_256 = dict(n_poses=256, n_points=768, n_objects=8, obs_per_object=8)


def test_forced_band_step_matches_jax_and_dense(monkeypatch):
    """Both gates forced on at 256 poses (16 x 4 tiles, cyclic reduction):
    the step equals the reference's band step and the port's dense step."""
    state, _, cams, tables, plan, free, weights, huber = jax_problem(**SIZE_256)
    for mod in (jschur, schur_mod):
        monkeypatch.setattr(mod, "_BAND_SOLVE", "on")
    for mod in (jbs, bs):
        monkeypatch.setattr(mod, "_BAND_CR", "on")
    ref = jax_compute_step(
        state, cams, tables, plan, free, weights, jnp.asarray(1e4), huber, dense_schur=True
    )
    args = [to_port(x) for x in (state, cams, tables, plan, free, weights)]
    calls = []
    inner = bs.woodbury_band_solve
    monkeypatch.setattr(bs, "woodbury_band_solve", lambda *a: calls.append(1) or inner(*a))
    band = compute_step(*args, 1e4, to_port(huber))
    assert len(calls) == 1
    monkeypatch.setattr(schur_mod, "_BAND_SOLVE", "off")
    dense = compute_step(*args, 1e4, to_port(huber))
    assert len(calls) == 1
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(band[0], name), getattr(ref[0], name)) <= 1e-9, name
        assert rel_err(getattr(band[0], name), getattr(dense[0], name)) <= 1e-8, name
    for ours, theirs in zip(band[1:], ref[1:]):
        assert abs(float(ours) - float(theirs)) <= 1e-9 * abs(float(theirs))


def test_banded_failed_factorization_zeroes_the_pose_step(monkeypatch):
    """A negative radius makes the band tiles indefinite: the pose step is
    zeroed (LM then rejects it), never raised."""
    monkeypatch.setattr(schur_mod, "_BAND_SOLVE", "on")
    calls = []
    inner = bs.woodbury_band_solve
    monkeypatch.setattr(bs, "woodbury_band_solve", lambda *a: calls.append(1) or inner(*a))
    state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        **SIZE_256, device="cpu"
    )
    d, _, _ = compute_step(state, cams, tables, plan, free, weights, -1.0, huber)
    assert len(calls) == 1
    assert torch.equal(d.poses, torch.zeros_like(d.poses))


class _LargestTensor(TorchDispatchMode):
    """Records the largest tensor any op creates."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_band_mode_allocates_no_s_sized_tensor():
    """At 512 poses (auto gate) the largest tensor any op of the step creates
    is K3's batch of group grams, G x 768 x 768 (linear in P; (6P)^2 / 2 at
    this size); with the band solve off, the fold buffer is larger than
    (6P)^2."""
    problem = synthetic_problem(n_poses=512, n_points=256, n_objects=2, obs_per_object=4,
                                device="cpu")
    state, _, cams, tables, plan, free, weights, huber = problem
    s_size = (6 * 512) ** 2
    sizes = {}
    for mode in ("auto", "off"):
        schur_mod._BAND_SOLVE = mode
        try:
            with _LargestTensor() as spy:
                compute_step(state, cams, tables, plan, free, weights, 1e4, huber)
        finally:
            schur_mod._BAND_SOLVE = "auto"
        sizes[mode] = spy.largest
    assert sizes["auto"] == plan.pt_band_local_pose.shape[0] * 768 * 768 < s_size, sizes
    assert sizes["off"] >= s_size, sizes
