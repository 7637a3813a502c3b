"""The port's long-term object map against the JAX package at f64 on CPU:
``compute_marginal_covariances`` (covariances, h_diag, the reduced system,
ridge, a failed inverse), extraction with the far-feature filter, the
rank-deficiency repair and the PSD clamp, JSON across packages, a second
session seeded from the map, and the pairwise-covariance map. Both packages
work on the same pose graph: the port's object session, copied into the
reference's PoseGraph. The session's chairs are asymmetric
(torch_object_helpers.ASYM_DIMS): with symmetric ones the yaw is
unobservable, the reduced system is singular to roundoff and its inverse
differs between any two implementations beyond 1e-8 of a block's largest
entry."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import ltm as jltm
from obvi_slam_tpu import ltm_pairwise as jltm_pairwise
from obvi_slam_tpu.pose_graph import CameraInfo as JaxCameraInfo
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.solver import problem as jproblem
from obvi_slam_tpu.solver import schur as jschur
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch import ltm as pltm
from obvi_slam_tpu_torch import ltm_pairwise as pltm_pairwise
from obvi_slam_tpu_torch.solver import problem as pproblem
from obvi_slam_tpu_torch.solver import schur as pschur
from torch_object_helpers import ASYM_DIMS, object_config, run_port_session
from torch_port_helpers import npy

torch.set_num_threads(1)


def _relpose_config(module, **overrides):
    """object_config with the odometry factors in every frame (the
    monocular session's scale gauge, as tests/test_ltm.py forces it)."""
    c = object_config(module, ASYM_DIMS)
    c.optimization_factors_enabled_params = dataclasses.replace(
        c.optimization_factors_enabled_params,
        min_low_level_feature_observations_per_frame=10**9, **overrides)
    return c


def _jax_copy(pg):
    return JaxPoseGraph.from_state(
        pg.get_state(),
        {c: JaxCameraInfo(**dataclasses.asdict(v)) for c, v in pg.cameras.items()},
        {k: (m.copy(), c.copy()) for k, (m, c) in pg.shape_mean_and_cov_by_class.items()},
    )


def _port_copy(pg):
    return ot.PoseGraph.from_state(
        pg.get_state(),
        {c: ot.pose_graph.CameraInfo(**dataclasses.asdict(v)) for c, v in pg.cameras.items()},
        {k: (m.copy(), c.copy()) for k, (m, c) in pg.shape_mean_and_cov_by_class.items()},
    )


@pytest.fixture(scope="module")
def session():
    data, gt_poses, gt_objects = ot.synthetic_object_session(dims=ASYM_DIMS)
    _, pg, fe = run_port_session(data, object_config(pcfg, ASYM_DIMS))
    return dict(data=data, pg=pg, fe=fe, gt_objects=gt_objects)


def _add_deficient_object(pg, frame):
    """An object with one bounding box and no shape prior: 4 residuals for
    7 parameters (tests/test_ltm.py's rank-deficient case)."""
    obj = pg.add_new_ellipsoid([1.0, 0.5, 6.0, 0, 0.6, 0.6, 1.0], "chair")
    for sid in pg.shape_priors_by_object.pop(obj, []):
        pg.shape_priors[sid] = None
    pg.add_object_observation(obj, frame, 1, np.array([300.0, 360.0, 200.0, 280.0]),
                              np.diag([900.0] * 4))
    return obj


def _extraction_problems(pg, jpg):
    c_ours, c_ref = _relpose_config(pcfg), _relpose_config(jcfg)
    n = pg.max_frame_id()
    ours = pproblem.build_problem(pg, pltm._extraction_scope(n, c_ours),
                                  c_ours.ltm_solver_residual_params, device="cpu")
    ref = jproblem.build_problem(jpg, jltm._extraction_scope(n, c_ref),
                                 c_ref.ltm_solver_residual_params)
    return ours, ref


def _marginals(problem, module_fn, **kw):
    p = problem
    return module_fn(p.state, p.cams, p.tables, p.plan, p.free, p.weights, p.huber,
                     return_reduced_hessian=True, **kw)


@pytest.mark.parametrize("ridge", [0.0, 5e-9, 1e-3])
def test_marginal_covariances_match_jax(session, ridge):
    """Covariances, h_diag and the reduced system at rtol 1e-8."""
    pg = session["pg"]
    ours_p, ref_p = _extraction_problems(pg, _jax_copy(pg))
    covs, h_diag, ok, red_h = _marginals(ours_p, pschur.compute_marginal_covariances,
                                         ridge=ridge)
    r_covs, r_h_diag, r_ok, r_red_h = _marginals(ref_p, jschur.compute_marginal_covariances,
                                                 ridge=ridge)
    assert bool(ok) == bool(r_ok)
    np.testing.assert_allclose(npy(red_h), np.asarray(r_red_h), rtol=1e-8, atol=1e-12)
    for k in ("pose", "point", "object"):
        np.testing.assert_allclose(npy(h_diag[k]), np.asarray(r_h_diag[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    n_obj = len(ours_p.obj_rows)
    c, r = npy(covs)[:n_obj], np.asarray(r_covs)[:n_obj]
    scale = np.abs(r).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(c / scale, r / scale, rtol=0, atol=1e-8)
    assert bool(ok) and np.all(np.isfinite(c))


def test_failed_inverse_reports_not_ok(session):
    """A non-finite reduced system (a NaN measurement) fails in both: ok is
    False and nothing raises."""
    pg = session["pg"]
    ours_p, ref_p = _extraction_problems(pg, _jax_copy(pg))
    bad = ours_p.tables.bbox.rect_corners.clone()
    bad[0, 0] = float("nan")
    ours_p.tables = ours_p.tables._replace(bbox=ours_p.tables.bbox._replace(rect_corners=bad))
    ref_bad = np.asarray(ref_p.tables.bbox.rect_corners).copy()
    ref_bad[0, 0] = np.nan
    ref_p.tables = ref_p.tables._replace(
        bbox=ref_p.tables.bbox._replace(rect_corners=jnp.asarray(ref_bad)))
    _, _, ok, _ = _marginals(ours_p, pschur.compute_marginal_covariances)
    _, _, r_ok, _ = _marginals(ref_p, jschur.compute_marginal_covariances)
    assert not bool(ok) and not bool(r_ok)


def _assert_same_ltm(ours, ref, atol=1e-8, skip=()):
    """Equal maps; each covariance within ``atol`` of its largest entry
    (``skip``: objects whose covariance is left to the caller)."""
    assert ours.ellipsoids.keys() == ref.ellipsoids.keys()
    for k, (cls, e) in ref.ellipsoids.items():
        assert ours.ellipsoids[k][0] == cls
        np.testing.assert_array_equal(ours.ellipsoids[k][1], e)
    assert ours.covariances.keys() == ref.covariances.keys()
    for k, cov in ref.covariances.items():
        if k in skip:
            continue
        scale = np.abs(cov).max()
        np.testing.assert_allclose(ours.covariances[k] / scale, cov / scale, rtol=0, atol=atol,
                                   err_msg=str(k))
    assert ours.front_end_data == ref.front_end_data


class TestExtraction:
    def test_extracts_objects_with_covariances(self, session):
        """tests/test_ltm.py's checks, and the JAX package's map."""
        pg, fe = session["pg"], session["fe"]
        ours = ot.extract_long_term_object_map(
            pg, _relpose_config(pcfg), fe.get_front_end_obj_map_data(), device="cpu")
        ref = jltm.extract_long_term_object_map(
            _jax_copy(pg), _relpose_config(jcfg),
            fe.get_front_end_obj_map_data())
        _assert_same_ltm(ours, ref)
        assert len(ours.ellipsoids) == 2
        for cov in ours.covariances.values():
            assert cov.shape == (7, 7) and np.all(np.diag(cov) > 0)
            np.testing.assert_allclose(cov / np.abs(cov).max(), cov.T / np.abs(cov).max(),
                                       atol=1e-6)
            assert np.all(np.diag(cov)[:3] < 10.0)
            assert cov[3, 3] > np.diag(cov)[:3].max()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_json_loads_in_both_packages(self, session, tmp_path, writer):
        pg, fe = session["pg"], session["fe"]
        ltm = ot.extract_long_term_object_map(
            pg, object_config(pcfg), fe.get_front_end_obj_map_data(), device="cpu")
        path = str(tmp_path / "ltm.json")
        if writer == "port":
            ltm.save(path)
        else:
            jltm.LongTermObjectMap(ltm.ellipsoids, ltm.covariances, ltm.front_end_data).save(path)
        for cls in (pltm.LongTermObjectMap, jltm.LongTermObjectMap):
            _assert_same_ltm(cls.load(path), ltm, atol=0)

    def test_far_feature_filter(self, session):
        pg = _port_copy(session["pg"])
        pg.features[99999] = np.array([0.0, 0.0, 1e4])
        pg.add_visual_factor(0, 1, 99999, np.array([320.0, 240.0]), 1.0)
        thr = pcfg.FullOVSLAMConfig().ltm_tunable_params.far_feature_threshold
        far = pltm.far_feature_ids(pg, thr)
        assert 99999 in far and 99999 not in pltm.far_feature_ids(pg, 1e6)
        assert far == jltm.far_feature_ids(_jax_copy(pg), thr)
        ours = ot.extract_long_term_object_map(pg, _relpose_config(pcfg), {}, device="cpu")
        ref = jltm.extract_long_term_object_map(
            _jax_copy(pg), _relpose_config(jcfg), {})
        _assert_same_ltm(ours, ref)


class TestRankDeficiencyRepair:
    def test_never_observed_object_gets_placeholder(self, session):
        pg = _port_copy(session["pg"])
        lonely = pg.add_new_ellipsoid([50.0, 50.0, 50.0, 0, 1, 1, 1], "chair")
        for sid in pg.shape_priors_by_object.pop(lonely, []):
            pg.shape_priors[sid] = None
        ltm = ot.extract_long_term_object_map(pg, object_config(pcfg), {}, device="cpu")
        np.testing.assert_array_equal(ltm.covariances[lonely], np.eye(7))

    @pytest.mark.parametrize("frame", [0, 3])
    def test_deficient_object_matches_jax(self, session, frame):
        """One box, no prior: the eigen analysis finds the null directions,
        weak priors repair them, the PSD clamp runs where needed. At frame 0
        (held constant) the object is decoupled from the rest of the graph
        and its covariance matches too; at frame 3 it couples to a free
        pose, its repaired system has eigenvalues from 5e-9 (the priors) to
        ~1e6, and its inverse is roundoff in both packages: it is held to
        tests/test_ltm.py's gates there, the other objects to the JAX map."""
        pg = _port_copy(session["pg"])
        obj = _add_deficient_object(pg, frame)
        maps = [
            ot.extract_long_term_object_map(
                pg, _relpose_config(pcfg, min_object_observations=1), {}, device="cpu"),
            jltm.extract_long_term_object_map(
                _jax_copy(pg), _relpose_config(jcfg, min_object_observations=1), {}),
        ]
        _assert_same_ltm(*maps, atol=1e-6, skip=() if frame == 0 else (obj,))
        for m in maps:
            cov = m.covariances[obj]
            assert np.all(np.isfinite(cov)) and np.diag(cov).max() > 1e2
            assert np.all(np.linalg.eigvalsh(0.5 * (cov + cov.T)) > -1e-9 * np.abs(cov).max())

    def test_find_rank_deficiencies_matches_jax(self):
        n_pose, n_obj = 2, 1
        dim = n_pose * 6 + n_obj * 7
        v0 = np.zeros(dim)
        v0[0] = v0[n_pose * 6 + 4] = 1.0
        v0 /= np.linalg.norm(v0)
        h = 10.0 * (np.eye(dim) - np.outer(v0, v0))
        state = {"pose": np.arange(12.0).reshape(2, 6), "object": np.arange(7.0)[None] + 100}
        found = pltm.find_rank_deficiencies(h, state, min_col_norm=5e-4)
        assert found == jltm.find_rank_deficiencies(h, state, min_col_norm=5e-4)
        assert {(k, r, c) for k, r, c, _, _ in found} == {(0, 0, 0), (2, 0, 4)}

    def test_psd_clamp_matches_jax(self):
        rng = np.random.default_rng(0)
        a = rng.normal(size=(19, 19))
        red_h = a @ a.T
        red_h[:, 0] = red_h[0, :] = 0.0
        bad = np.stack([np.diag([1.0, -1.0, 1, 1, 1, 1, 1])])
        ours = pltm._ensure_psd_covs(bad, red_h, 2, 5e-4)
        np.testing.assert_array_equal(ours, jltm._ensure_psd_covs(bad, red_h, 2, 5e-4))
        assert np.all(np.linalg.eigvalsh(ours) > 0)

    def test_fallback_to_previous(self, monkeypatch):
        prev = pltm.LongTermObjectMap({5: ("chair", np.arange(7.0))}, {5: np.eye(7)})
        monkeypatch.setattr(pltm, "_extract", lambda *a, **k: None)
        out = ot.extract_long_term_object_map(ot.PoseGraph({}, {}), object_config(pcfg), {},
                                              prev_ltm=prev, device="cpu")
        assert out is prev


def test_second_session_reassociates_ltm_objects(session, tmp_path):
    """tests/test_ltm.py::TestMultiSession on the port: the map goes through
    JSON, seeds a second session of the same scene (other noise), whose
    detections merge into the map's objects instead of duplicating them."""
    pg, fe = session["pg"], session["fe"]
    path = str(tmp_path / "ltm.json")
    ot.extract_long_term_object_map(pg, object_config(pcfg), fe.get_front_end_obj_map_data(),
                                    device="cpu").save(path)
    ltm = pltm.LongTermObjectMap.load(path)
    assert len(ltm.ellipsoids) == 2
    data2, _, _ = ot.synthetic_object_session(seed=99)
    _, pg2, _ = run_port_session(data2, object_config(pcfg), ltm=ltm)
    assert set(ltm.ellipsoids) <= set(pg2.objects) | set(pg2.merged_objects)
    assert set(pg2.objects) == set(ltm.ellipsoids)
    assert all(len(pg2.obj_obs_by_object[o]) > 0 for o in pg2.objects)


def test_pairwise_covariance_map_matches_jax(session, tmp_path):
    pg = session["pg"]
    ours = pltm_pairwise.extract_pairwise_covariance_ltm(pg, _relpose_config(pcfg), {},
                                                         device="cpu")
    ref = jltm_pairwise.extract_pairwise_covariance_ltm(
        _jax_copy(pg), _relpose_config(jcfg), {})
    assert ours.pairwise_covariances.keys() == ref.pairwise_covariances.keys()
    objs = sorted(pg.objects)
    assert (objs[0], objs[1]) in ours.pairwise_covariances
    # The blocks of one host inverse of a system of condition ~5e12: each
    # within 1e-8 of the largest entry of all blocks.
    scale = max(np.abs(c).max() for c in ref.pairwise_covariances.values())
    for k, cov in ref.pairwise_covariances.items():
        np.testing.assert_allclose(ours.pairwise_covariances[k] / scale, cov / scale, rtol=0,
                                   atol=1e-8, err_msg=str(k))
    path = str(tmp_path / "pltm.json")
    ours.save(path)
    back = jltm_pairwise.PairwiseCovarianceLongTermObjectMap.load(path)
    np.testing.assert_array_equal(back.pairwise_covariances[(objs[0], objs[1])],
                                  ours.pairwise_covariances[(objs[0], objs[1])])
    assert set(ours.to_independent().covariances) == set(objs)
