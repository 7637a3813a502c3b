"""The port's Jacobian debug oracle (``solver/jacobian_debug``, the
``debug_jacobian_hessian_diagonal`` CLI) and the standalone epipolar factor
against the JAX package at f64 on the CPU."""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

from obvi_slam_tpu import types as jt
from obvi_slam_tpu.factors import epipolar as jepi
from obvi_slam_tpu.solver import jacobian_debug as jjd
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch.cli import debug_jacobian_hessian_diagonal as debug_cli
from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as main_cli
from obvi_slam_tpu_torch.factors import epipolar as epi
from obvi_slam_tpu_torch.solver import jacobian_debug as jd
from test_torch_runner import SESSION, small_config
from torch_cli_helpers import cli_args, export
from torch_port_helpers import jax_problem, to_port

_spec = importlib.util.spec_from_file_location(
    "jax_debug_cli",
    Path(__file__).resolve().parents[1] / "cli" / "debug_jacobian_hessian_diagonal.py")
jax_debug_cli = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_debug_cli)

torch.set_num_threads(1)

SIZE = dict(n_poses=6, n_points=20, n_objects=3, obs_per_point=3, obs_per_object=4, seed=2)


def _every_family():
    """A JAX synthetic problem with LTM priors on objects 0 and 2 besides the
    reprojection, bounding-box, shape and relative-pose tables."""
    state, _, cams, tables, plan, free, weights, huber = jax_problem(**SIZE)
    rng = np.random.default_rng(5)
    mean = np.asarray(state.objects)[[0, 2]] + rng.normal(size=(2, 7)) * 0.05
    sqrt_inf = np.stack([np.diag(rng.uniform(1.0, 3.0, 7)) for _ in range(2)])
    ltm = jt.make_ltm_prior_factors([0, 2], mean, sqrt_inf, capacity=4)
    return state, cams, tables._replace(ltm=ltm), free, huber


def _both(state, cams, tables, huber):
    ref = jjd.extract_jacobian(state, cams, tables, huber)
    ours = jd.extract_jacobian(to_port(state), to_port(cams), to_port(tables), to_port(huber))
    return ours, ref


def test_extract_jacobian_matches_jax():
    state, cams, tables, _, huber = _every_family()
    ours, ref = _both(state, cams, tables, huber)
    assert {name for name, _ in ref.row_owner} == {
        "reprojection", "bounding_box", "shape_prior", "relative_pose", "ltm_prior"}
    assert (ours.n_rows, ours.n_cols) == (ref.n_rows, ref.n_cols)
    assert ours.row_owner == ref.row_owner and ours.col_owner == ref.col_owner
    np.testing.assert_array_equal(ours.rows, ref.rows)
    np.testing.assert_array_equal(ours.cols, ref.cols)
    assert ours.vals.dtype == ref.vals.dtype == np.float64
    np.testing.assert_allclose(ours.vals, ref.vals, rtol=1e-10, atol=1e-12)


def test_validate_zero_columns_finds_an_unconstrained_point():
    """Point 4 loses every reprojection factor: its three columns are zero,
    and only a free-column mask that fixes it hides them."""
    state, cams, tables, free, huber = _every_family()
    rp = tables.reproj
    tables = tables._replace(reproj=rp._replace(
        mask=jnp.asarray(np.asarray(rp.mask) & (np.asarray(rp.point_idx) != 4))))
    ours, ref = _both(state, cams, tables, huber)
    got, want = jd.validate_zero_columns(ours), jjd.validate_zero_columns(ref)
    assert got == want
    assert {(kind, row) for kind, row, _, _ in got} == {("point", 4)}
    free_cols = np.ones(ours.n_cols, bool)
    free_cols[6 * SIZE["n_poses"] + 12: 6 * SIZE["n_poses"] + 15] = False
    assert jd.validate_zero_columns(ours, free_cols) == jjd.validate_zero_columns(
        ref, free_cols) == []


def test_hessian_diagonal_and_csv_match_jax(tmp_path):
    state, cams, tables, _, huber = _every_family()
    ours, ref = _both(state, cams, tables, huber)
    np.testing.assert_allclose(jd.hessian_diagonal(ours), jjd.hessian_diagonal(ref), rtol=1e-10)
    # The writer: the same triplets give the same text.
    same = jd.JacobianInfo(ref.rows, ref.cols, ref.vals, ref.n_rows, ref.n_cols,
                           ref.col_owner, ref.row_owner)
    jd.write_jacobian_csv(same, str(tmp_path / "ours" / "jac.csv"))
    jjd.write_jacobian_csv(ref, str(tmp_path / "ref" / "jac.csv"))
    for name in ("jac.csv", "jac_columns.csv"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "ref" / name).read_text()
    # The port's own extraction: the same rows, columns and attribution,
    # values at 1e-10.
    jd.write_jacobian_csv(ours, str(tmp_path / "own" / "jac.csv"))
    a = np.loadtxt(tmp_path / "own" / "jac.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "ref" / "jac.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=1e-10, atol=1e-12)
    own, want = ((tmp_path / d / "jac_columns.csv").read_text().splitlines()
                 for d in ("own", "ref"))
    assert [x.rsplit(",", 1)[0] for x in own] == [x.rsplit(",", 1)[0] for x in want]
    np.testing.assert_allclose([float(x.rsplit(",", 1)[1]) for x in own[1:]],
                               [float(x.rsplit(",", 1)[1]) for x in want[1:]], rtol=1e-10)


def _epipolar_case():
    """Two poses observing one world point: the pixels satisfy the epipolar
    constraint exactly (tests/test_debug_tools.py:49), on a stereo-offset
    second camera, plus a padding row."""
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    p1 = np.zeros(6)
    p2 = np.array([0.5, 0.05, 0.0, 0.0, 0.02, 0.0])
    point = np.array([0.4, -0.2, 6.0])
    c2t = np.array([0.12, 0.0, 0.0])

    def project(pose, cam_t):
        r = Rotation.from_rotvec(pose[3:]).as_matrix()
        pc = r.T @ (point - pose[:3]) - cam_t
        return np.array([500 * pc[0] / pc[2] + 320, 500 * pc[1] / pc[2] + 240])

    args = ([0, 0], [1, 1], [project(p1, 0), project(p1, 0)], [project(p2, 0), project(p2, c2t)],
            [k, k], [k, k], [np.eye(3)] * 2, [np.zeros(3)] * 2, [np.eye(3)] * 2,
            [np.zeros(3), c2t])
    return p1, p2, args


@pytest.mark.parametrize("perturbed", [False, True], ids=["on-plane", "perturbed"])
def test_epipolar_matches_jax(perturbed):
    p1, p2, args = _epipolar_case()
    if perturbed:
        p2 = p2 + np.array([0, 0.1, 0, 0, 0, 0.01])
    f_ref = jepi.make_epipolar_factors(*args, sigma=2.0, capacity=3)
    f = epi.make_epipolar_factors(*args, sigma=2.0, capacity=3, device="cpu")
    poses = np.stack([p1, p2])
    state_ref = jt.BAState(jnp.asarray(poses), jnp.zeros((1, 3)), jnp.zeros((1, 7)))
    state = to_port(state_ref)
    for name in f._fields:
        np.testing.assert_allclose(getattr(f, name).numpy(), np.asarray(getattr(f_ref, name)),
                                   rtol=1e-15, atol=1e-15, err_msg=name)
    r = epi.epipolar_residuals(state, f)
    assert r.dtype == torch.float64
    np.testing.assert_allclose(r.numpy(), np.asarray(jepi.epipolar_residuals(state_ref, f_ref)),
                               rtol=1e-10, atol=1e-14)
    if not perturbed:
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-10)
    ours = epi.epipolar_residuals_and_jac(state, f)
    ref = jepi.epipolar_residuals_and_jac(state_ref, f_ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-14)
    assert float(ours[0][2]) == 0.0 and not ours[1][2].any() and not ours[2][2].any()
    if perturbed:
        assert abs(float(ours[0][0])) > 1e-4


def test_epipolar_f32_keeps_its_dtype():
    _, p2, args = _epipolar_case()
    f = epi.make_epipolar_factors(*args, sigma=2.0, dtype=np.float32, device="cpu")
    state = ot.types.BAState(torch.tensor(np.stack([np.zeros(6), p2]), dtype=torch.float32),
                             torch.zeros((1, 3)), torch.zeros((1, 7)))
    r, j1, j2 = epi.epipolar_residuals_and_jac(state, f)
    assert r.dtype == j1.dtype == j2.dtype == torch.float32


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def test_debug_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the final pose-graph checkpoint of the port's 8-frame
    visual session (written by the port's main CLI): the same printed lines
    and the same triplets."""
    data, gt, _ = ot.synthetic_session(**SESSION)
    d = export(data, gt, tmp_path / "files", small_config(), detections=False)
    assert main_cli.main(cli_args(d, tmp_path / "session")) == 0
    common = ["--input_checkpoint_file", str(tmp_path / "session" / "checkpoints" /
                                            "pose_graph_state.json"),
              "--params_config_file", str(d / "config.json"),
              "--intrinsics_file", str(d / "intrinsics.csv"),
              "--extrinsics_file", str(d / "extrinsics.csv"), "--min_col_norm", "2.0"]
    rc, ours = _run(debug_cli.main, common + ["--device", "cpu", "--jacobian_output_file",
                                              str(tmp_path / "ours" / "jac.csv")])
    rc_ref, ref = _run(jax_debug_cli.main, common + ["--jacobian_output_file",
                                                     str(tmp_path / "ref" / "jac.csv")])
    assert rc == rc_ref == 0
    assert len(ours) == len(ref) >= 5
    assert ours[:-1] == ref[:-1]
    assert ours[-1] == ref[-1].replace("ref", "ours")
    a = np.loadtxt(tmp_path / "ours" / "jac.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "ref" / "jac.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=1e-10, atol=1e-12)
