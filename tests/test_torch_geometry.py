"""Geometry and the five residual families of obvi_slam_tpu_torch against the
JAX reference at f64 on CPU, small-angle branches included."""

import numpy as np
import pytest
import torch

import jax

from obvi_slam_tpu import factors as jfac
from obvi_slam_tpu import geometry as jgeo
from obvi_slam_tpu import types as jt
from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import geometry as geo
from torch_port_helpers import assert_close, jax_problem, npy, to_port

torch.set_num_threads(1)

RTOL, ATOL = 1e-11, 1e-13


def _rotvecs(rng, n):
    """Random rotation vectors, with exact zeros and angles far below the
    small-angle switch mixed in."""
    w = rng.normal(size=(n, 3)) * rng.choice([1e-12, 1e-9, 1e-5, 0.3, 2.5], size=(n, 1))
    w[:3] = 0.0
    return w


def test_so3_maps_match_jax():
    rng = np.random.default_rng(0)
    w = _rotvecs(rng, 64)
    wt = torch.from_numpy(w)
    assert_close(geo.skew(wt), jgeo.skew(w), RTOL, ATOL)
    assert_close(geo.exp_so3(wt), jgeo.exp_so3(w), RTOL, ATOL)
    assert_close(geo.right_jacobian_so3(wt), jgeo.right_jacobian_so3(w), RTOL, ATOL)
    r = np.array(jgeo.exp_so3(w))
    assert_close(geo.quat_from_matrix(torch.from_numpy(r)), jgeo.quat_from_matrix(r), RTOL, ATOL)
    assert_close(geo.log_so3(torch.from_numpy(r)), jgeo.log_so3(r), RTOL, ATOL)


def test_pose_ops_and_projections_match_jax():
    rng = np.random.default_rng(1)
    n = 32
    p1 = np.concatenate([rng.normal(size=(n, 3)), _rotvecs(rng, n)], 1)
    p2 = np.concatenate([rng.normal(size=(n, 3)), _rotvecs(rng, n)], 1)
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    assert_close(geo.pose_compose(t1, t2), jgeo.pose_compose(p1, p2), RTOL, ATOL)
    assert_close(geo.pose_between(t1, t2), jgeo.pose_between(p1, p2), RTOL, ATOL)
    assert_close(geo.pose_inverse(t1), jgeo.pose_inverse(p1), RTOL, ATOL)

    cam_r = np.array(jgeo.exp_so3(rng.normal(size=(n, 3)) * 0.1))
    cam_t = rng.normal(size=(n, 3)) * 0.1
    point = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 8.0])
    ours = geo.project_point_rectified(
        t1 * 0.1, torch.from_numpy(point), torch.from_numpy(cam_r), torch.from_numpy(cam_t)
    )
    ref = jgeo.project_point_rectified(p1 * 0.1, point, cam_r, cam_t)
    for a, b in zip(ours, ref):
        assert_close(a, b, RTOL, ATOL)

    ell = np.concatenate(
        [point, rng.uniform(-1, 1, (n, 1)), rng.uniform(0.5, 3.0, (n, 3))], 1
    )
    ell[:4, :3] = p1[:4, :3] * 0.1  # camera inside: invalid projections
    ours = geo.ellipsoid_corners_rectified(
        torch.from_numpy(ell), t1 * 0.1, torch.from_numpy(cam_r), torch.from_numpy(cam_t)
    )
    ref = jgeo.ellipsoid_corners_rectified(ell, p1 * 0.1, cam_r, cam_t)
    assert_close(ours[0], ref[0], 1e-10, 1e-12)
    assert np.array_equal(npy(ours[1]), np.asarray(ref[1]))
    assert not npy(ours[1]).all()


def _problem_with_priors():
    """A synthetic window plus live LTM and parameter priors."""
    state, _, cams, tables, *_ = jax_problem(n_poses=12, n_points=48, n_objects=4, seed=2)
    rng = np.random.default_rng(5)
    objs = np.asarray(state.objects)
    a = rng.normal(size=(3, 7, 7)) * 0.2
    ltm = jt.make_ltm_prior_factors(
        [0, 2, 3], objs[[0, 2, 3]] + rng.normal(size=(3, 7)) * 0.05,
        np.eye(7) + a @ a.transpose(0, 2, 1), capacity=5,
    )
    prior = jt.make_param_prior_factors(
        [0, 1, 2, 0], [3, 7, 1, 11], [4, 2, 6, 0],
        rng.normal(size=4) * 0.1, [10.0, 3.0, 2.0, 5.0], capacity=6,
    )
    return state, cams, tables._replace(ltm=ltm, param_prior=prior)


def test_residual_families_match_jax():
    state, cams, tables = _problem_with_priors()
    s, c, t = to_port(state), to_port(cams), to_port(tables)
    assert_close(fac.reproj_residuals(s, c, t.reproj), jfac.reproj_residuals(state, cams, tables.reproj), 1e-10, 1e-12)
    assert_close(fac.bbox_residuals(s, c, t.bbox), jfac.bbox_residuals(state, cams, tables.bbox), 1e-9, 1e-11)
    for ours, ref in (
        (fac.shape_residuals_and_jac(s, t.shape), jfac.shape_residuals_and_jac(state, tables.shape)),
        (fac.relpose_residuals_and_jac(s, t.relpose), jax.jit(jfac.relpose_residuals_and_jac)(state, tables.relpose)),
        (fac.ltm_residuals_and_jac(s, t.ltm), jfac.ltm_residuals_and_jac(state, tables.ltm)),
    ):
        for a, b in zip(ours, ref):
            assert a.shape == b.shape
            assert_close(a, b, 1e-9, 1e-11)
    assert_close(
        fac.param_prior_residuals(s, t.param_prior),
        jfac.param_prior_residuals(state, tables.param_prior), RTOL, ATOL,
    )
    ours = fac.all_residuals(s, c, t)
    ref = jax.jit(jfac.all_residuals)(state, cams, tables)
    assert set(ours) == set(ref)
    for k in ref:
        assert_close(ours[k], ref[k], 1e-9, 1e-11, err_msg=k)


@pytest.mark.parametrize("delta", [0.5, 1.0, 10.0])
def test_huber_matches_jax(delta):
    s = np.concatenate([[0.0, 1e-40], np.geomspace(1e-6, 1e4, 40)])
    st = torch.from_numpy(s)
    assert_close(fac.huber_rho(st, delta), jfac.huber_rho(s, delta), RTOL, ATOL)
    assert_close(fac.huber_sqrt_weight(st, delta), jfac.huber_sqrt_weight(s, delta), RTOL, ATOL)


def test_total_cost_matches_jax():
    state, cams, tables = _problem_with_priors()
    rng = np.random.default_rng(9)
    weights = {
        f"{k}_weight": (rng.uniform(size=getattr(tables, k).capacity) > 0.2).astype(np.float64)
        for k in ("reproj", "bbox", "shape", "relpose", "ltm")
    }
    kw = dict(huber_reproj=1.0, huber_bbox=0.5, huber_shape=10.0, huber_relpose=1.0, huber_ltm=2.0)
    ours = fac.total_cost(
        to_port(state), to_port(cams), to_port(tables), **kw,
        **{k: torch.from_numpy(v) for k, v in weights.items()},
    )
    ref = jfac.total_cost(state, cams, tables, **kw, **weights)
    assert ours.dim() == 0
    assert abs(float(ours) - float(ref)) <= 1e-10 * abs(float(ref))
