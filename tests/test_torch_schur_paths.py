"""The Schur paths beside the slot grams against the JAX package at
f64 on the CPU: pair enumeration (``dense_schur=False``), the dense U built
from the pairs for an over-budget slot grid, the automatic path choice
(``schur.choose_paths``) on an out-and-back (loop-closure) relabelling, and
a two-phase solve of that problem; the f32 pair path against the f64 one;
the card's choice between the dense U and pair enumeration
(``schur._PAIR_WORK_FACTOR``) at the chip phases' and sessions' shapes."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obvi_slam_tpu.solver import lm_fused as jlm
from obvi_slam_tpu.solver import two_phase as jtp
from obvi_slam_tpu.solver.lm import LMParams as JaxLMParams
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import compute_step
from obvi_slam_tpu_torch.solver import LMParams, TwoPhaseConfig, solve_two_phase
from obvi_slam_tpu_torch.solver import schur as schur_mod
from obvi_slam_tpu_torch.solver.plan import build_schur_plan_host
from obvi_slam_tpu_torch.solver.problem import PLAN_CAP_KEYS
from test_torch_lm import _assert_same_summary
from test_torch_step import IDS, SIZES, _weights, jax_compute_step
from torch_port_helpers import jax_problem, npy, out_and_back, rel_err, to_port

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOOP = dict(n_poses=192, n_points=768, n_objects=8, seed=0)


def _jax_step(prob, weights, radius, dense_schur):
    state, _, cams, tables, plan, free, _, huber = prob
    return jax_compute_step(state, cams, tables, plan, free, weights, jnp.asarray(radius),
                            huber, dense_schur=dense_schur)


def _port_step(prob, weights, radius, dense_schur=None, dtype=None):
    state, _, cams, tables, plan, free, _, huber = prob
    schur_mod.reset_path_counts()
    out = compute_step(*(to_port(x, dtype) for x in (state, cams, tables)), to_port(plan),
                       to_port(free), to_port(weights, dtype), radius, to_port(huber),
                       dense_schur=dense_schur)
    return out, dict(schur_mod.path_counts)


def _assert_same_step(ours, ref, tol=1e-9):
    (d, mc, g), (d_ref, mc_ref, g_ref) = ours, ref
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(d, name), getattr(d_ref, name)) <= tol, name
    assert abs(float(mc) - float(mc_ref)) <= tol * abs(float(mc_ref))
    assert abs(float(g) - float(g_ref)) <= tol * abs(float(g_ref))


def _mapped_back(delta, old_of_new):
    """A step of the relabelled problem in the original pose numbering."""
    poses = npy(delta.poses)
    back = np.empty_like(poses)
    back[old_of_new] = poses
    return delta._replace(poses=back)


@pytest.mark.parametrize("mode,radius", [("ones", 1e4), ("dropped", 3.0)])
@pytest.mark.parametrize("size", SIZES, ids=IDS)
def test_pair_enumeration_matches_jax(size, mode, radius):
    prob = jax_problem(**size)
    weights = _weights(prob[3], mode)
    ours, paths = _port_step(prob, weights, radius, dense_schur=False)
    assert paths == {"steps": 1, "pair_enumeration": 1}
    _assert_same_step(ours, _jax_step(prob, weights, radius, False))


def _slot_elems(plan, n_pose, kind):
    return int(np.prod(getattr(plan, f"{kind}_slot_gather").shape)) * n_pose


@pytest.mark.parametrize("dense_schur", [None, True], ids=["auto", "forced"])
@pytest.mark.parametrize("kind,size", [("points", SIZES[1]), ("objects", SIZES[0]),
                                       ("both", SIZES[0]), ("both", SIZES[1])],
                         ids=["points-24", "objects-16", "both-16", "both-24"])
def test_dense_from_pairs_matches_jax_slot_path(kind, size, dense_schur, monkeypatch):
    """A slot grid over _SLOT_BUDGET takes the dense U built from the pairs
    (the budget patched below the grid's size; the JAX package's budget is
    a local), by the automatic choice (these shapes lie far on the dense
    side of _PAIR_WORK_FACTOR) and forced: its step against the JAX
    package's slot-gram step."""
    prob = jax_problem(**size)
    n_pose = size["n_poses"]
    pt, ob = (_slot_elems(prob[4], n_pose, k) for k in ("pt", "ob"))
    budget = {"points": ob, "objects": pt, "both": min(pt, ob) - 1}[kind]
    want = {"points": ("pt_dense_from_pairs", "ob_slot"),
            "objects": ("pt_slot", "ob_dense_from_pairs"),
            "both": ("pt_dense_from_pairs", "ob_dense_from_pairs")}[kind]
    monkeypatch.setattr(schur_mod, "_SLOT_BUDGET", budget)
    weights = _weights(prob[3], "dropped")
    ours, paths = _port_step(prob, weights, 3.0, dense_schur=dense_schur)
    assert paths == dict({"steps": 1}, **{name: 1 for name in want})
    _assert_same_step(ours, _jax_step(prob, weights, 3.0, True))


@pytest.mark.parametrize("path", ["pair", "dense-from-pairs", "dense-from-pairs-forced"])
@pytest.mark.parametrize("size", SIZES, ids=IDS)
def test_f32_pair_paths_track_f64(size, path, monkeypatch):
    """The bound of tests/test_f32_precision.py:57-60 for the reference's
    f32 pair path, and for the dense U from the pairs by the automatic
    choice and forced."""
    if path != "pair":
        monkeypatch.setattr(schur_mod, "_SLOT_BUDGET", 1)
    dense = {"pair": False, "dense-from-pairs": None, "dense-from-pairs-forced": True}[path]
    steps = {}
    for dtype in (np.float64, np.float32):
        state, _, cams, tables, plan, free, weights, huber = ot.synthetic_problem(
            **size, dtype=dtype, device="cpu")
        steps[dtype] = compute_step(state, cams, tables, plan, free, weights, 1e4, huber,
                                    dense_schur=dense)
    (d64, mc64, _), (d32, mc32, _) = steps[np.float64], steps[np.float32]
    assert d32.poses.dtype == torch.float32
    assert rel_err(d32.poses, d64.poses) < 5e-3
    assert rel_err(d32.points, d64.points) < 5e-3
    assert abs(float(mc32) - float(mc64)) / abs(float(mc64)) < 5e-3


@pytest.fixture(scope="module")
def loop():
    """The 192 x 768 x 8 problem (banded: every landmark's poses within
    its 128-pose window) and its out-and-back relabelling (not banded)."""
    prob = jax_problem(**LOOP)
    relabelled, old_of_new = out_and_back(prob)
    return prob, relabelled, old_of_new


def test_out_and_back_is_a_loop_closure(loop):
    prob, relabelled, old_of_new = loop
    assert prob[4].pt_band_local_pose is not None
    assert relabelled[4].pt_band_local_pose is None and relabelled[4].rel_band_local_pose is None
    assert sorted(old_of_new) == list(range(LOOP["n_poses"])) and old_of_new[0] == 0
    rp = relabelled[3].reproj
    pose, point = np.asarray(rp.pose_idx)[np.asarray(rp.mask)], np.asarray(rp.point_idx)[
        np.asarray(rp.mask)]
    span = np.zeros(LOOP["n_points"], int)
    np.maximum.at(span, point, pose)
    low = np.full(LOOP["n_points"], LOOP["n_poses"])
    np.minimum.at(low, point, pose)
    assert np.mean(span - low >= LOOP["n_poses"] // 2) > 0.5  # seen from both legs


def test_chip_smoke_fixture_is_the_helpers_twin(loop):
    """chip_smoke.out_and_back on the port's problem (the same draws) gives
    the tables, free mask and plan of the tests' JAX twin."""
    _, relabelled, old_of_new = loop
    ours, order = chip_smoke.out_and_back(ot.synthetic_problem(**LOOP, device="cpu"))
    np.testing.assert_array_equal(order, old_of_new)
    for got, want in ((ours[0], relabelled[0]), (ours[3], relabelled[3]), (ours[4], relabelled[4]),
                      (ours[5], relabelled[5])):
        for g, w in zip(torch.utils._pytree.tree_leaves(to_port(got)),
                        torch.utils._pytree.tree_leaves(to_port(want))):
            np.testing.assert_array_equal(npy(g), npy(w))


def test_out_and_back_auto_matches_jax(loop):
    """The automatic choice on the loop closure: the JAX package's natural
    path against the port's."""
    _, relabelled, _ = loop
    weights = relabelled[6]
    ours, paths = _port_step(relabelled, weights, 1e4)
    assert "band_solve" not in paths and "pt_band_slot" not in paths
    _assert_same_step(ours, _jax_step(relabelled, weights, 1e4, None))


@pytest.mark.parametrize("dense_schur", [None, False], ids=["auto", "pair"])
def test_out_and_back_step_equals_banded_step(loop, dense_schur):
    """The same problem in two numberings: the loop closure's step (slot
    grams or pair enumeration), mapped back, against the banded step."""
    prob, relabelled, old_of_new = loop
    (d_band, mc_band, g_band), band_paths = _port_step(prob, prob[6], 1e4)
    assert "pt_band_slot" in band_paths
    (d, mc, g), _ = _port_step(relabelled, relabelled[6], 1e4, dense_schur=dense_schur)
    _assert_same_step((_mapped_back(d, old_of_new), mc, g), (d_band, mc_band, g_band))


def test_pair_path_on_a_banded_plan(loop):
    """Pair enumeration on a banded plan assembles a pose-major S; the port
    solves it in that order and matches the JAX package's slot-gram step.
    (The JAX package's dense_schur=False there pairs its pose-major S with a
    component-major RHS and returns another step: ROADMAP Queue 3.)"""
    prob, _, _ = loop
    weights = prob[6]
    ours, paths = _port_step(prob, weights, 1e4, dense_schur=False)
    assert paths == {"steps": 1, "pair_enumeration": 1}
    ref = _jax_step(prob, weights, 1e4, True)
    _assert_same_step(ours, ref)
    jax_pair = _jax_step(prob, weights, 1e4, False)
    assert rel_err(jax_pair[0].poses, ref[0].poses) > 0.5


def test_out_and_back_auto_over_the_factor_matches_jax_dense_step(loop, monkeypatch):
    """An over-budget point slot grid (the budget patched below it; the JAX
    package's is a local) where the dense U gram would do more than
    _PAIR_WORK_FACTOR times pair enumeration's work: the automatic choice
    enumerates pairs and returns the JAX package's dense step."""
    _, relabelled, _ = loop
    plan, weights = relabelled[4], relabelled[6]
    n_pose, n_point = LOOP["n_poses"], LOOP["n_points"]
    monkeypatch.setattr(schur_mod, "_SLOT_BUDGET", _slot_elems(plan, n_pose, "pt") - 1)
    assert _slot_elems(plan, n_pose, "ob") <= schur_mod._SLOT_BUDGET
    dense_work = (6 * n_pose) ** 2 * 3 * n_point
    assert dense_work > schur_mod._PAIR_WORK_FACTOR * 108 * plan.pt_cross_a.shape[0]
    ours, paths = _port_step(relabelled, weights, 1e4)
    assert paths == {"steps": 1, "pair_enumeration": 1}
    _assert_same_step(ours, _jax_step(relabelled, weights, 1e4, True))


def _window_plan(data, pool, lo, hi, visual=True):
    """The host plan of frames [lo, hi] of ``data`` at the capacities of
    ``pool``: the window's feature observations (none when not
    ``visual``) and a relpose chain."""
    rp_pose, rp_point, n_land = [], [], 0
    for track in data.feature_tracks.values() if visual else ():
        frames = [f for f in sorted(track) if lo <= f <= hi]
        for f in frames:
            rp_pose += [f - lo] * len(track[f])
            rp_point += [n_land] * len(track[f])
        n_land += bool(frames)
    rel = np.arange(min(hi, data.max_frame_id()) - lo)
    plan = build_schur_plan_host(
        rp_pose, rp_point, pool["reproj"], [], [], pool["bbox"],
        caps={k: pool[k] for k in PLAN_CAP_KEYS}, n_pose=pool["n_pose"],
        rl_before=rel, rl_after=rel + 1, rl_cap=pool["relpose"], device="cpu")
    return plan, pool["n_pose"], pool["n_point"]


# The object session of the benchmark's objects.dense_chairs cell: 240
# stereo frames, 3360 landmarks, 44 chairs, PGO on its global-BA frames.
DENSE_CHAIRS = dict(chip_smoke.OBJECTS, n_frames=240, n_features=3360, n_objects=44)


@pytest.fixture(scope="module")
def session_plans():
    """Host plans at the capacities ``presize_session_caps`` seeds: the
    visual session's (chip_smoke.SESSION) first window and whole session
    ("local" and "global" pools), and the object session's PGO (no visual
    factors) and post-PGO feature BA over the whole session ("pgo" and
    "pgo_vf" pools)."""
    data, _, _ = ot.synthetic_session(**chip_smoke.SESSION)
    runner = ot.OfflineProblemRunner(ot.config.FullOVSLAMConfig(), device="cpu")
    pools = runner.presize_session_caps(data)
    window = runner.config.sliding_window_params.local_ba_window_size
    plans = {"local": _window_plan(data, pools["local"], 0, window),
             "global": _window_plan(data, pools["global"], 0, data.max_frame_id())}
    data, _, _ = ot.synthetic_object_session(**DENSE_CHAIRS)
    runner = ot.OfflineProblemRunner(chip_smoke.object_config(), device="cpu")
    pools = runner.presize_session_caps(data)
    last = data.max_frame_id()
    plans["pgo"] = _window_plan(data, pools["pgo"], 0, last, visual=False)
    plans["pgo_vf"] = _window_plan(data, pools["pgo_vf"], 0, last)
    return plans


@pytest.mark.parametrize("label,want,ratio", [
    ("loop_768", ("pair_enumeration",), 12288),
    ("loop_1024", ("pair_enumeration",), None),
    ("scale_1024", ("pt_band_slot", "ob_slot", "band_solve"), None),
    ("loop_tracks", ("pt_dense_from_pairs", "ob_slot"), 288),
    ("session_local", ("pt_slot", "ob_slot"), None),
    ("session_global", ("pt_slot", "ob_slot"), None),
    ("session_pgo", ("pt_dense_from_pairs", "ob_dense_from_pairs"), 64 / 3),
    ("session_pgo_vf", ("pt_dense_from_pairs", "ob_dense_from_pairs"), 64 / 3),
    ("window", ("pt_slot", "ob_slot"), None),
])
def test_choose_paths_at_the_chip_phases_shapes(label, want, ratio, session_plans):
    """The decision at chip_smoke's phase shapes (1024 or 768 poses x 16384
    points x 64 objects, 768 poses x 2048 points seen 40 times, the
    64-pose window), its session's windows and the PGO-family solves of
    the objects.dense_chairs session (256 poses x 4096 points), from plans
    built on the host with no solve. Where the point slot grid is over
    budget and U within its limit, the card enumerates pairs exactly when
    the dense U gram would do more than _PAIR_WORK_FACTOR times their work
    (``ratio``: the work ratio of the decision); the banded layout, the
    sessions' windows and the dense-layout window never reach that rule."""
    if label.startswith("session_"):
        plan, n_pose, n_point = session_plans[label[len("session_"):]]
    else:
        prob = ot.synthetic_problem(**chip_smoke.PHASES[label][0], device="cpu")
        loop = label in chip_smoke.LOOP_PATHS
        plan = chip_smoke.out_and_back(prob)[0][4] if loop else prob[4]
        n_pose, n_point = prob[0].poses.shape[0], prob[0].points.shape[0]
    paths = schur_mod.choose_paths(plan, n_pose, n_point)
    assert paths.labels() == want
    assert chip_smoke.LOOP_PATHS.get(label, want) == want
    dense_work, pair_work = schur_mod.schur_work(plan, n_pose, n_point)
    assert dense_work == (6 * n_pose) ** 2 * 3 * n_point
    assert pair_work == 108 * plan.pt_cross_a.shape[0]
    if ratio is not None:
        assert dense_work / pair_work == pytest.approx(ratio, rel=1e-12)
        assert (dense_work > schur_mod._PAIR_WORK_FACTOR * pair_work) == (not paths.dense)


def test_crossover_tool_rehearses_on_the_cpu(tmp_path):
    """schur_crossover.py's control flow at a tiny size: each mode takes
    its path, and the pair step tracks the dense one."""
    import json

    import schur_crossover

    out = tmp_path / "crossover.json"
    assert schur_crossover.main(["--device", "cpu", "--poses", "16", "--points", "256",
                                 "--objects", "4", "--out", str(out)]) == 0
    (line,) = json.loads(out.read_text())["lines"]
    modes = {name: m["paths"] for name, m in line["modes"].items()}
    assert modes == {"dense_from_pairs": ["ob_slot", "pt_dense_from_pairs"],
                     "pairs": ["pair_enumeration"]}
    assert line["work_ratio"] == pytest.approx(line["dense_macs"] / line["pair_macs"])
    assert line["pose_gap_pairs_vs_dense"] < 1e-3


@pytest.mark.parametrize("dense_schur", [None, False], ids=["auto", "pair"])
def test_two_phase_out_and_back_matches_jax(dense_schur):
    """One two-phase solve of the out-and-back 16 x 64 x 4 problem against
    the JAX package's fused two-phase solve, at tests/test_torch_lm.py's
    tolerances; the port also through pair enumeration."""
    ref, _ = out_and_back(jax_problem(**SIZES[0]))
    state, _, cams, tables, plan, free, weights, huber = ref
    n_obj = tables.shape.obj_idx.shape[0]
    jax_aux = jtp.TwoPhaseAux(is_ltm_obj=jnp.zeros(n_obj, dtype=bool),
                              shape_live=tables.shape.mask)
    cfg = TwoPhaseConfig()
    final_ref, s1_ref, s2_ref = jlm.solve_two_phase_fused(
        state, cams, tables, plan, free, weights, jax_aux, JaxLMParams(), JaxLMParams(), huber,
        jtp.TwoPhaseConfig(**cfg._asdict()))
    schur_mod.reset_path_counts()
    final, s1, s2 = solve_two_phase(
        *(to_port(x) for x in ref[:1] + ref[2:7]), to_port(jax_aux), LMParams(), LMParams(),
        to_port(huber), cfg, dense_schur=dense_schur)
    steps = s1.num_iterations + s2.num_iterations
    assert schur_mod.path_counts.get("pair_enumeration", 0) == (
        steps if dense_schur is False else 0)
    _assert_same_summary(s1, s1_ref)
    _assert_same_summary(s2, s2_ref)
    for name in ("poses", "points", "objects"):
        assert rel_err(getattr(final, name), getattr(final_ref, name)) <= 1e-7
