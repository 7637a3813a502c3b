"""Multi-device global BA of obvi_slam_tpu_torch (``parallel``) on gloo ranks
on the CPU, against the single-process port and the JAX package's sharded
step on a 4-device mesh, at f64: ``compute_step`` on 2 and 4 ranks on the
dense 64-pose window, the banded 256-pose problem, the 512-pose band solve
(domain-decomposed at h = 2 and 4) and pair enumeration on an out-and-back
relabelling; a two-phase solve; the collective budget of the 256-pose step
and of the domain-decomposed 512-pose step (f32, the reference's shapes);
the runner and the CLI on 2 ranks; ``shard_sessions`` and ``initialize``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from obvi_slam_tpu import parallel as jpar
from obvi_slam_tpu_torch import compute_step, parallel as par, synthetic_problem
from obvi_slam_tpu_torch.solver import lm_fused
from obvi_slam_tpu_torch.solver import schur as schur_mod
from obvi_slam_tpu_torch.solver.lm import LMParams
from obvi_slam_tpu_torch.solver.two_phase import TwoPhaseAux, TwoPhaseConfig
from torch_mp import run_ranks
from torch_port_helpers import jax_problem, out_and_back, rel_err, to_port

torch.set_num_threads(1)

# The JAX problems of the sharded steps (a loop: relabelled out and back) and
# their compute_step keywords.
CASES = {
    "dense64": dict(size=dict(n_poses=64, n_points=1024, n_objects=8, obs_per_point=4,
                              obs_per_object=6)),
    "banded256": dict(size=dict(n_poses=256, n_points=384, n_objects=4, obs_per_point=6,
                                obs_per_object=6)),
    "dd512": dict(size=dict(n_poses=512, n_points=512, n_objects=4, obs_per_point=6,
                            obs_per_object=6)),
    "pairs": dict(size=dict(n_poses=192, n_points=768, n_objects=8, seed=0), loop=True,
                  kwargs=dict(dense_schur=False)),
}
# The Schur paths each case's steps must take.
PATHS = {"dense64": ("pt_slot", "ob_slot"), "banded256": ("pt_band_slot", "ob_slot"),
         "dd512": ("pt_band_slot", "band_solve"), "pairs": ("pair_enumeration",)}
# The reference's collective-budget shapes, f32 (tests/test_sharding_collectives.py).
BUDGET = {"budget256": dict(n_poses=256, n_points=4096, n_objects=16, obs_per_point=6,
                            obs_per_object=12, dtype=np.float32),
          "budget512": dict(n_poses=512, n_points=4096, n_objects=16, obs_per_point=6,
                            obs_per_object=12, dtype=np.float32)}
TWO_PHASE = (LMParams(max_num_iterations=6), LMParams(max_num_iterations=6), TwoPhaseConfig())
RADIUS = 1e4


@functools.lru_cache(maxsize=None)
def jax_case(name):
    c = CASES[name]
    prob = jax_problem(**c["size"])
    return out_and_back(prob)[0] if c.get("loop") else prob


def port_args(name):
    state, _, cams, tables, plan, free, weights, huber = jax_case(name)
    return [to_port(x) for x in (state, cams, tables, plan, free, weights)] + [
        RADIUS, to_port(huber)]


def _aux(args):
    state, tables = args[0], args[2]
    return TwoPhaseAux(is_ltm_obj=torch.zeros(state.objects.shape[0], dtype=torch.bool),
                       shape_live=tables.shape.mask.clone())


def _inputs(n_ranks):
    inputs = {name: dict(args=port_args(name), kwargs=c.get("kwargs", {}))
              for name, c in CASES.items()}
    inputs["dense64"]["two_phase"] = (_aux(inputs["dense64"]["args"]),) + TWO_PHASE
    for name, size in BUDGET.items():
        state, _, cams, tables, plan, free, weights, huber = synthetic_problem(
            **size, device="cpu")
        inputs[name] = dict(args=[state, cams, tables, plan, free, weights, RADIUS, huber])
    return inputs


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"step{request.param}")
    torch.save(_inputs(request.param), out / "inputs.pt")
    return request.param, run_ranks("step", request.param, out, timeout=240)


@functools.lru_cache(maxsize=None)
def single(name):
    args = port_args(name)
    schur_mod.reset_path_counts()
    step = compute_step(*args, plain=True, **CASES[name].get("kwargs", {}))
    return step, dict(schur_mod.path_counts)


@functools.lru_cache(maxsize=None)
def jax_sharded(name):
    """The JAX package's sharded_compute_step on 4 of the 8 virtual devices."""
    state, _, cams, tables, plan, free, weights, huber = jax_case(name)
    mesh = jpar.make_mesh(jax.devices()[:4])
    kw = CASES[name].get("kwargs", {})
    if kw:
        from obvi_slam_tpu.solver import schur as jschur

        def step(*a):
            return jschur.compute_step(*a, huber, shard_mesh=mesh, **kw)

        step = jax.jit(step)
    else:
        inner = jpar.sharded_compute_step(mesh)

        def step(*a):
            return inner(*a, huber)
    return step(jpar.replicate(state, mesh), jpar.replicate(cams, mesh),
                jpar.shard_tables(tables, mesh), jpar.shard_plan(plan, mesh),
                jpar.replicate(free, mesh), jpar.shard_weights(weights, mesh),
                jnp.asarray(RADIUS))


def _assert_step(got, ref, tol=1e-9):
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(got[0], name), getattr(ref[0], name)) <= tol, name
    for ours, theirs in zip(got[1:], ref[1:]):
        assert abs(float(ours) - float(theirs)) <= tol * abs(float(theirs))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single_process_and_jax(ranks, name):
    """Every rank's step equals rank 0's bit for bit, the single-process
    port step and the JAX package's 4-device sharded step within 1e-9."""
    n, results = ranks
    first = results[0][name]
    got = (first["delta"], first["mc"], first["gm"])
    for r in results[1:]:
        for a, b in zip(r[name]["delta"], first["delta"]):
            assert torch.equal(a, b)
        assert torch.equal(r[name]["mc"], first["mc"]) and torch.equal(r[name]["gm"], first["gm"])
    ref, paths = single(name)
    _assert_step(got, ref)
    _assert_step(got, jax_sharded(name))
    assert first["paths"] == paths
    for label in PATHS[name]:
        assert paths.get(label) == 1, paths


def test_dd_domains_follow_the_mesh(ranks):
    """The 512-pose band solve (8 tiles) runs one domain per rank on 2 and 4
    ranks: its all-gathers are the interface and halo blocks of h = n."""
    n, results = ranks
    assert schur_mod._dd_domains(par.Mesh(n, 0, None, torch.device("cpu")), 8) == n
    shapes = results[0]["dd512"]["collectives"]["all-gather"]["shapes"]
    assert f"f64[{n},384,384]" in shapes, shapes


def test_sharded_two_phase_matches_single_process(ranks):
    """solve_two_phase on the ranks (outlier ranking over the gathered
    residuals) against the single-process solve: same iterations, costs and
    state."""
    n, results = ranks
    args = port_args("dense64")
    state, cams, tables, plan, free, weights, _, huber = args
    final, s1, s2 = lm_fused.solve_two_phase(state, cams, tables, plan, free, weights,
                                             _aux(args), *TWO_PHASE[:2], huber, TWO_PHASE[2],
                                             plain=True)
    for r in results:
        got = r["dense64"]["two_phase"]
        for (i0, f0, it), s in zip(got["costs"], (s1, s2)):
            assert it == s.num_iterations
            assert abs(f0 - s.final_cost) <= 1e-9 * s.final_cost
        for a, b in zip(got["final"], final):
            assert rel_err(a, b) <= 1e-9
        for a, b in zip(got["final"], results[0]["dense64"]["two_phase"]["final"]):
            assert torch.equal(a, b)


def test_collective_budget_256(ranks):
    """The banded 256-pose step at the reference's shapes: two all-reduces
    (the packed H/b/W sums, the partial S), inside the reference's 4-40 MB
    envelope; one all-gather of the relpose rows and the step's broadcast."""
    n, results = ranks
    by_op = results[0]["budget256"]["collectives"]
    counts = {k: v["count"] for k, v in by_op.items()}
    assert counts == {"all-reduce": 2, "all-gather": 1, "broadcast": 1}, by_op
    assert "f32[2359296]" in by_op["all-reduce"]["shapes"], by_op  # the (6P)^2 partial S
    assert 4e6 < par.audit.all_reduce_bytes(by_op) < 40e6, by_op


def test_collective_budget_dd512(ranks):
    """The domain-decomposed 512-pose step (h = n): no all-gather operand
    above (h, 384, 512) f32 and under 20 MB of all-gathers in all."""
    n, results = ranks
    by_op = results[0]["budget512"]["collectives"]
    assert results[0]["budget512"]["paths"].get("band_solve") == 1
    ag = by_op["all-gather"]
    for s in ag["shapes"]:
        dims = [int(d) for d in s[s.index("[") + 1:-1].split(",")]
        assert int(np.prod(dims)) <= n * 384 * 512, s
    assert ag["bytes"] < 20e6, ag
