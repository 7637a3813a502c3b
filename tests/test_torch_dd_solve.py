"""The domain-decomposed band solve of obvi_slam_tpu_torch
(``band_solve.dd_woodbury_band_solve``) against the JAX package's and
numpy's at f64 on CPU: the batched form at four domain splits, its argument
checks, and the one-domain-per-rank form on 4 gloo ranks (tiles given, and
deferred gram quadrants with the relpose updates) against the reference's
shard_map form on 4 of the conftest's 8 virtual devices."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from obvi_slam_tpu import parallel as jpar
from obvi_slam_tpu.solver import band_solve as jbs
from obvi_slam_tpu_torch.solver import band_solve as bs
from test_band_solve import _random_block_tridiag
from torch_mp import run_ranks

torch.set_num_threads(1)

T = torch.tensor


def _system(nb, m, rz, seed):
    d, e, dense = _random_block_tridiag(nb, m, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.normal(size=(rz, nb * m)) * 0.2
    s = dense - z.T @ z
    assert np.linalg.eigvalsh(s).min() > 0
    return d, e, z, s, rng.normal(size=nb * m)


@pytest.mark.parametrize("nb,h", [(8, 2), (8, 4), (12, 3), (16, 8)])
def test_batched_dd_matches_jax_and_dense(nb, h):
    """Every domain split, 2-tile domains (1-tile interiors) included."""
    d, e, z, s, rhs = _system(nb, 8, 9, 11 + nb + h)
    x, ok = bs.dd_woodbury_band_solve(T(d), T(e), T(z), T(rhs), n_domains=h)
    assert bool(ok)
    ref = np.asarray(jax.jit(functools.partial(jbs.dd_woodbury_band_solve, n_domains=h))(
        *map(jnp.asarray, (d, e, z, rhs))))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(s, rhs), rtol=1e-8, atol=1e-8)


def test_batched_cyclic_reduction_batches_independent_systems():
    """cr_factor / cr_solve over a leading axis == each system alone."""
    systems = [_random_block_tridiag(5, 6, seed=40 + k) for k in range(3)]
    d = T(np.stack([s[0] for s in systems]))
    e = T(np.stack([s[1] for s in systems]))
    rhs = T(np.random.default_rng(3).normal(size=(3, 5, 6, 2)))
    x = bs.cr_solve(bs.cr_factor(d, e), rhs)
    for k in range(3):
        alone = bs.cr_solve(bs.cr_factor(d[k], e[k]), rhs[k])
        np.testing.assert_allclose(x[k].numpy(), alone.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(
            x[k].numpy().reshape(-1, 2),
            np.linalg.solve(systems[k][2], rhs[k].numpy().reshape(-1, 2)), rtol=1e-9, atol=1e-12)


def test_dd_argument_checks():
    """Where the reference raises: a split that does not divide or leaves one
    tile per domain, deferred tiles without one domain per rank, and gram
    quadrants without the relpose updates (checked before any collective)."""
    from obvi_slam_tpu_torch.parallel import Mesh

    m = 8
    d, e, _ = _random_block_tridiag(6, m, seed=13)
    z, rhs = torch.zeros((1, 6 * m), dtype=torch.float64), torch.zeros(6 * m, dtype=torch.float64)
    for h in (4, 6):
        with pytest.raises(ValueError):
            bs.dd_woodbury_band_solve(T(d), T(e), z, rhs, n_domains=h)
        with pytest.raises(ValueError):
            jbs.dd_woodbury_band_solve(*map(jnp.asarray, (d, e, z.numpy(), rhs.numpy())),
                                       n_domains=h)
    quads = tuple(torch.zeros((6, 6, 2, 6, 2), dtype=torch.float64) for _ in range(3))
    scatter = tuple(torch.zeros(1, dtype=torch.long) for _ in range(4)) + (
        torch.zeros((1, 6, 6), dtype=torch.float64),)
    z, rhs = torch.zeros((1, 72), dtype=torch.float64), torch.zeros(72, dtype=torch.float64)
    with pytest.raises(ValueError, match="one domain per rank"):
        bs.dd_woodbury_band_solve(None, None, z, rhs, n_domains=3, rel_scatter=scatter,
                                  gram_quads=quads)
    mesh = Mesh(3, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="together"):
        bs.dd_woodbury_band_solve(None, None, z, rhs, n_domains=3, mesh=mesh, gram_quads=quads)


def _deferred_case(nb=16, tp=2, rz=5, seed=31):
    """Random quadrants and relpose updates whose folded system is SPD
    (tests/test_band_solve.py's deferred case)."""
    rng = np.random.default_rng(seed)
    q00 = rng.normal(size=(nb, 6, tp, 6, tp)) * 0.1
    q10 = rng.normal(size=(nb, 6, tp, 6, tp)) * 0.05
    q11 = rng.normal(size=(nb, 6, tp, 6, tp)) * 0.1
    n_pose = nb * tp
    bidx = np.arange(n_pose - 1)
    rows = np.concatenate([np.arange(n_pose), bidx, bidx + 1])
    cols = np.concatenate([np.arange(n_pose), bidx + 1, bidx])
    cross = rng.normal(size=(n_pose - 1, 6, 6)) * 0.05
    vals = np.concatenate([np.stack([np.eye(6) * 8.0] * n_pose), cross,
                           np.swapaxes(cross, -1, -2)])
    t_r, t_c = rows // tp, cols // tp
    scatter = (np.where(t_r == t_c, t_r, nb), np.where(t_r == t_c + 1, t_c, nb),
               rows % tp, cols % tp, vals)
    z = rng.normal(size=(rz, nb * 6 * tp)) * 0.1
    return (q00, q10, q11), scatter, z, rng.normal(size=nb * 6 * tp)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The per-rank form on 4 gloo ranks: tiles given (16 tiles, 4 per
    domain; 8 tiles, 2 per domain) and the deferred quadrants."""
    cases = {}
    for nb in (16, 8):
        d, e, z, s, rhs = _system(nb, 8, 9, 21 + nb)
        cases[f"tiles{nb}"] = dict(d=T(d), e=T(e), z=T(z), rhs=T(rhs), dense=s)
    quads, scatter, z, rhs = _deferred_case()
    cases["deferred"] = dict(gram_quads=tuple(map(T, quads)), rel_scatter=tuple(map(T, scatter)),
                             z=T(z), rhs=T(rhs))
    out = tmp_path_factory.mktemp("dd4")
    torch.save({k: {n: v for n, v in c.items() if n != "dense"} for k, c in cases.items()},
               out / "inputs.pt")
    return cases, run_ranks("dd_solve", 4, out, timeout=90)


def _jax_mesh4():
    assert len(jax.devices()) >= 4
    return jpar.make_mesh(jax.devices()[:4])


@pytest.mark.parametrize("nb", [16, 8])
def test_rank_form_matches_jax_shard_map(four_ranks, nb):
    cases, results = four_ranks
    c = cases[f"tiles{nb}"]
    ref = np.asarray(jax.jit(functools.partial(
        jbs.dd_woodbury_band_solve, n_domains=4, shard_mesh=_jax_mesh4(), shard_axis="factors"))(
        *(jnp.asarray(c[k].numpy()) for k in ("d", "e", "z", "rhs"))))
    for r in results:
        got = r[f"tiles{nb}"]
        assert got["ok"]
        np.testing.assert_allclose(got["x"].numpy(), ref, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(got["x"].numpy(), np.linalg.solve(c["dense"], c["rhs"].numpy()),
                                   rtol=1e-8, atol=1e-8)
        assert torch.equal(got["x"], results[0][f"tiles{nb}"]["x"])


def test_rank_form_deferred_matches_jax_shard_map(four_ranks):
    cases, results = four_ranks
    c = cases["deferred"]
    solve = jax.jit(lambda z, rhs, scatter, quads: jbs.dd_woodbury_band_solve(
        None, None, z, rhs, n_domains=4, shard_mesh=_jax_mesh4(), shard_axis="factors",
        rel_scatter=scatter, gram_quads=quads))
    ref = np.asarray(solve(jnp.asarray(c["z"].numpy()), jnp.asarray(c["rhs"].numpy()),
                           tuple(jnp.asarray(a.numpy()) for a in c["rel_scatter"]),
                           tuple(jnp.asarray(q.numpy()) for q in c["gram_quads"])))
    for r in results:
        assert r["deferred"]["ok"]
        np.testing.assert_allclose(r["deferred"]["x"].numpy(), ref, rtol=1e-8, atol=1e-10)
        assert torch.equal(r["deferred"]["x"], results[0]["deferred"]["x"])


def test_rank_form_collectives(four_ranks):
    """All-gathers of halo and interface blocks (each at most (h, m, 1 + rz)
    or (h, m, m)), all-reduces of the Woodbury products and the ok flag; no
    other collective."""
    _, results = four_ranks
    by_op = results[0]["tiles16"]["collectives"]
    assert set(by_op) == {"all-gather", "all-reduce"}, by_op
    assert all(s.startswith("f64[4,") for s in by_op["all-gather"]["shapes"]), by_op
    assert by_op["all-gather"]["bytes"] < 4 * 8 * (3 * 8 * 8 + 4 * 8 * 10 + 64 * 4), by_op
