"""A second session seeded from the first session's long-term object map, on
the port at f64 on the CPU: the extraction's marginal covariances against
the benchmark's plain float64 reference (``benchmark/reference/
covariance.py``), with and without the rank-deficiency repair, and the
repair's priors against the reference's null directions; the spans inside
``ltm_extraction`` and the LTM counters; and session 2's capacity pools,
presized from the raw data and the map's objects, which no window
outgrows (the counters of a fallback and of a merge, and the cell's
readers: ``test_torch_ltm_counters.py``). Two sessions of one route (20 and 16 frames) past four
asymmetric chairs (torch_object_helpers.ASYM_DIMS: with symmetric ones the
yaw is unobservable and the inverse differs between two implementations
beyond 1e-9 of a block's largest entry)."""

import copy

import numpy as np
import pytest
import torch

import obvi_slam_tpu_torch as ot
from benchmark.drivers.session import _huber, _plain_arrays
from benchmark import harness
from benchmark.reference import build, covariance
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch import ltm as pltm
from obvi_slam_tpu_torch.solver import schur as pschur
from obvi_slam_tpu_torch.timing import TimerRegistry
from torch_object_helpers import ASYM_DIMS, object_config, run_port_session

torch.set_num_threads(1)

SESSION = dict(n_objects=4, n_features=80, dims=ASYM_DIMS, odom_noise=0.01)
EXTRACTION_SPANS = ("ltm_far_features", "ltm_covariance", "ltm_rank_check", "ltm_psd")
LIMITS = harness.load_json(harness.BENCH_DIR / "workloads" / "objects.ltm_revisit.json")[
    "limits"]
LIMIT = LIMITS["covariance_error"]


def _extract_capturing(pg, config, fe, prev_ltm):
    """(the LTM of ``pg``, the (args, kwargs) of each marginal-covariance
    call the extraction made, its problem)."""
    calls, problems = [], []
    covs, build_problem = pltm.compute_marginal_covariances, pltm.build_problem

    def keep_call(*args, **kwargs):
        calls.append((args, kwargs))
        return covs(*args, **kwargs)

    def keep_problem(*args, **kwargs):
        problems.append(build_problem(*args, **kwargs))
        return problems[-1]

    pltm.compute_marginal_covariances, pltm.build_problem = keep_call, keep_problem
    try:
        ltm = ot.extract_long_term_object_map(pg, config, fe.get_front_end_obj_map_data(),
                                              prev_ltm=prev_ltm, device="cpu")
    finally:
        pltm.compute_marginal_covariances, pltm.build_problem = covs, build_problem
    return ltm, calls, problems[-1]


@pytest.fixture(scope="module")
def sessions():
    config = object_config(pcfg, ASYM_DIMS)
    data1, _, _ = ot.synthetic_object_session(n_frames=20, seed=31, **SESSION)
    _, pg1, fe1 = run_port_session(data1, config)
    ltm1 = ot.extract_long_term_object_map(pg1, config, fe1.get_front_end_obj_map_data(),
                                           device="cpu")
    data2, _, _ = ot.synthetic_object_session(n_frames=16, seed=32, **SESSION)
    presized = {}
    presize = ot.OfflineProblemRunner.presize_session_caps

    def spy(runner, *args, **kwargs):
        pools = presize(runner, *args, **kwargs)
        presized.update(copy.deepcopy(pools))
        return pools

    mp = pytest.MonkeyPatch()
    mp.setattr(ot.OfflineProblemRunner, "presize_session_caps", spy)
    pltm.reset_ltm_stats()
    registry = TimerRegistry.instance()
    registry.record_spans(True)
    try:
        runner2, pg2, fe2 = run_port_session(data2, config, ltm=ltm1)
        seeded = dict(pltm.ltm_stats)
        pltm.reset_ltm_stats()
        ltm2, calls, problem = _extract_capturing(pg2, config, fe2, ltm1)
        spans = list(registry.spans)
    finally:
        registry.record_spans(False)
        mp.undo()
    return dict(config=config, ltm1=ltm1, runner2=runner2, pg2=pg2, fe2=fe2, ltm2=ltm2,
                calls=calls, problem=problem, spans=spans, seeded=seeded,
                extracted=dict(pltm.ltm_stats), presized=presized)


@pytest.fixture(scope="module")
def repaired(sessions):
    """Session 2's extraction with one more object, seen once from the
    constant first pose with no shape prior (4 residuals for 7 parameters),
    which the repair must fix. The repair's priors have the strength of
    ``min_col_norm``; at the default 5e-9 the repaired system's eigenvalues
    span 1e12 and its inverse is roundoff in any two implementations, so
    here ``min_col_norm`` is 1e-2."""
    config = copy.deepcopy(sessions["config"])
    config.optimization_factors_enabled_params.min_object_observations = 1
    config.ltm_tunable_params.min_col_norm = 1e-2
    pg = ot.PoseGraph.from_state(sessions["pg2"].get_state(), sessions["pg2"].cameras,
                                 pcfg.shape_prior_map(config))
    obj = pg.add_new_ellipsoid([1.0, 0.5, 6.0, 0, 0.6, 0.6, 1.0], "chair")
    for sid in pg.shape_priors_by_object.pop(obj, []):
        pg.shape_priors[sid] = None
    pg.add_object_observation(obj, 0, 1, np.array([300.0, 360.0, 200.0, 280.0]),
                              np.diag([900.0] * 4))
    pltm.reset_ltm_stats()
    ltm, calls, _ = _extract_capturing(pg, config, sessions["fe2"], None)
    return dict(ltm=ltm, calls=calls, stats=dict(pltm.ltm_stats))


def _arrays(call):
    """(the reference's arrays of one captured call, its Huber scales)."""
    state, cams, tables, _, free, weights, huber = call[0][:7]
    return _plain_arrays(state, cams, tables, free, weights), _huber(huber)


def _program_and_reference(call):
    """The port's object covariances of one captured call and the
    reference's, both over the reference's (compacted) objects."""
    args, kwargs = call
    covs = pschur.compute_marginal_covariances(*args[:7], plain=kwargs.get("plain", False))[0]
    prob = build.plain_problem(*_arrays(call))
    ref = covariance.marginal_covariances(prob)
    return covs.numpy()[prob.keep["objects"]], ref.numpy()


@pytest.mark.parametrize("case", ["plain", "repaired"])
def test_marginal_covariances_match_the_reference(sessions, repaired, case):
    calls = sessions["calls"] if case == "plain" else repaired["calls"]
    if case == "repaired":
        assert len(calls) == 2 and int(calls[-1][0][2].param_prior.mask.sum()) > 0
    ours, ref = _program_and_reference(calls[-1])
    assert ref.shape[0] >= 4 and np.all(np.isfinite(ref))
    for k in range(ref.shape[0]):
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-9 * scale)
    assert covariance.relative_error(ours, ref) <= LIMIT


def test_the_repair_holds_every_null_direction(sessions, repaired):
    """The reference's null directions of the problem without the repair's
    priors lie on the parameters the priors hold; with every prior taken
    out, or those of the object whose parameters hold a null direction, a
    direction has none. The plain session's problem has no null
    direction."""
    limit = LIMITS["rank_repair_uncovered"]
    plain = covariance.repair_uncovered(build.plain_problem(*_arrays(sessions["calls"][-1])))
    assert plain[:2] == (0.0, 0)
    arrays, huber = _arrays(repaired["calls"][-1])
    uncovered, n_null, low, gap = covariance.repair_uncovered(build.plain_problem(arrays, huber))
    assert n_null >= 1 and low < covariance.NULL_TOL < gap
    assert uncovered <= limit
    held = arrays["prior_mask"].astype(bool)
    is_obj = arrays["prior_kind"] == 2
    faults = []
    for drop in [held] + [is_obj & (arrays["prior_block"] == o)
                          for o in sorted(set(arrays["prior_block"][held & is_obj].tolist()))]:
        planted = dict(arrays, prior_mask=held & ~drop)
        faults.append(covariance.repair_uncovered(build.plain_problem(planted, huber)))
    assert all(f[1] == n_null for f in faults)
    assert faults[0][0] > limit and max(f[0] for f in faults[1:]) > limit


def test_the_maps_covariances_are_the_references(sessions):
    """The extracted map's covariances (through the PSD check, no clamp)
    against the reference on the extraction problem, as the cell checks
    them."""
    ltm2, rows = sessions["ltm2"], sessions["problem"].obj_rows
    _, ref = _program_and_reference(sessions["calls"][-1])
    args, _ = sessions["calls"][-1]
    prob = build.plain_problem(_plain_arrays(*args[:3], args[4], args[5]), _huber(args[6]))
    ours = np.stack([ltm2.covariances[int(o)] for o in rows])[prob.keep["objects"]]
    assert sessions["extracted"]["psd_clamps"] == 0
    assert set(ltm2.ellipsoids) == set(sessions["pg2"].objects)
    assert set(sessions["ltm1"].ellipsoids) <= set(ltm2.covariances)
    assert covariance.relative_error(ours, ref) <= LIMIT


def test_a_moved_entry_fails_the_check(sessions):
    ours, ref = _program_and_reference(sessions["calls"][-1])
    moved = ours.copy()
    moved[1, 2, 3] += 1e-6 * np.abs(moved[1]).max()
    assert covariance.relative_error(ours, ref) <= LIMIT
    assert covariance.relative_error(moved, ref) > LIMIT


def test_spans_nest_inside_the_extraction(sessions):
    spans = sessions["spans"]
    last = sessions["pg2"].max_frame_id()
    inner = [s for s in spans if s.name in EXTRACTION_SPANS]
    assert {s.name for s in inner} == set(EXTRACTION_SPANS)
    (outer,) = [s for s in spans if s.name == "ltm_extraction"]
    for s in inner:
        assert s.parent == "ltm_extraction" and s.frame == last == outer.frame
        assert outer.start_s <= s.start_s <= s.end_s <= outer.end_s
    order = sorted(inner, key=lambda s: s.start_s)
    assert all(a.end_s <= b.start_s for a, b in zip(order, order[1:]))
    (seed,) = [s for s in spans if s.name == "ltm_seed"]
    assert seed.end_s <= outer.start_s


def test_counters_count_what_happened(sessions, repaired):
    n_ltm = len(sessions["ltm1"].ellipsoids)
    assert sessions["seeded"] == dict(seeded=n_ltm, extractions=0, repaired_params=0,
                                      psd_clamps=0, fallbacks=0)
    assert sessions["extracted"] == dict(seeded=0, extractions=1, repaired_params=0,
                                         psd_clamps=0, fallbacks=0)
    params = int(repaired["calls"][-1][0][2].param_prior.mask.sum())
    assert repaired["stats"]["repaired_params"] == params > 0
    pg2 = sessions["pg2"]
    reobserved = [o for o in pg2.ltm_object_ids if pg2.obj_obs_by_object.get(o)]
    assert reobserved and sessions["fe2"].ltm_merges >= len(reobserved)


def test_session_two_pools_do_not_grow_after_presizing(sessions):
    pools = sessions["runner2"]._caps_pools
    n_ltm = len(sessions["ltm1"].ellipsoids)
    assert sessions["presized"] and pools == sessions["presized"]
    assert all(p["ltm"] >= n_ltm for p in pools.values())
