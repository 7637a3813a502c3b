"""Plain versions of kernels K1 (reprojection), K2 (bounding box), K3 (banded
z build + group gram) and K4 (syrk gram) in obvi_slam_tpu_torch against the
JAX reference: its Pallas kernels in interpret mode and its XLA paths, at f64
on CPU (K3 and K4 also at f32 against the Pallas split-bf16 grams). The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from obvi_slam_tpu import types as jt
from obvi_slam_tpu.factors.reproj_fast import reproj_residuals_and_jac_fast as jax_reproj_fast
from obvi_slam_tpu.factors.residuals import bbox_residuals_and_jac
from obvi_slam_tpu.ops import band_gram_pallas, syrk_pallas
from obvi_slam_tpu.ops.bbox_pallas import bbox_residuals_and_jac_pallas
from obvi_slam_tpu.ops.reproj_pallas import BLOCK_F, reproj_residuals_and_jac_pallas
from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import ops
from obvi_slam_tpu_torch.ops import band_gram, syrk
from torch_port_helpers import assert_close, jax_problem, npy, to_port

torch.set_num_threads(1)

jax_bbox_jacfwd = jax.jit(bbox_residuals_and_jac)

# Tolerances of tests/test_pallas_kernel.py: K1 rtol 1e-10 (r) / 1e-9 (J),
# K2 rtol 1e-9 (r) / 1e-8 (J); the XLA and kernel forms differ in rounding.
K1_TOL = ((1e-10, 1e-12), (1e-9, 1e-11), (1e-9, 1e-11))
K2_TOL = ((1e-9, 1e-11), (1e-8, 1e-10), (1e-8, 1e-10))


def _check_outputs(port_out, ref_out, tols, what):
    for name, a, b, (rtol, atol) in zip(("r", "J_a", "J_b"), port_out, ref_out, tols):
        assert a.shape == tuple(np.shape(b)), f"{what} {name}: {a.shape}"
        assert_close(a, b, rtol, atol, err_msg=f"{what} {name}")


@pytest.mark.parametrize(
    "size",
    [dict(n_poses=12, n_points=48, n_objects=4, seed=4),
     dict(n_poses=8, n_points=30, n_objects=2, obs_per_point=3, seed=9)],
    ids=["12-48-4", "8-30-2"],
)
def test_reproj_plain_matches_jax(size):
    state, _, cams, tables, *_ = jax_problem(**size)
    f = tables.reproj
    assert f.capacity % BLOCK_F != 0, "exercise the padded Pallas block"
    out = fac.reproj_residuals_and_jac_fast(to_port(state), to_port(cams), to_port(f))
    _check_outputs(out, jax_reproj_fast(state, cams, f), K1_TOL, "vs XLA fast path")
    _check_outputs(
        out, reproj_residuals_and_jac_pallas(state, cams, f, interpret=True), K1_TOL,
        "vs Pallas interpret",
    )


def _garbage_padded(table, cls, n_extra):
    """The table with ``n_extra`` masked rows that copy live rows (non-zero
    garbage the kernels must not read into the outputs)."""
    fields = {}
    for name, col in table._asdict().items():
        col = np.asarray(col)
        extra = np.zeros((n_extra,) + col.shape[1:], bool) if name == "mask" else col[:n_extra]
        fields[name] = np.concatenate([col, extra])
    return cls(**fields)


def test_reproj_masked_rows_are_exact_zeros():
    state, _, cams, tables, *_ = jax_problem(n_poses=12, n_points=48, n_objects=4, seed=4)
    f = _garbage_padded(tables.reproj, jt.ReprojectionFactors, 37)
    out = fac.reproj_residuals_and_jac_fast(to_port(state), to_port(cams), to_port(f))
    live = np.asarray(f.mask)
    for a in out:
        assert np.array_equal(npy(a)[~live], np.zeros_like(npy(a)[~live]))
    _check_outputs(out, jax_reproj_fast(state, cams, f), K1_TOL, "padded")


def test_bbox_plain_matches_jax():
    state, _, cams, tables, *_ = jax_problem(
        n_poses=12, n_points=48, n_objects=4, obs_per_object=10, seed=4
    )
    f = _garbage_padded(tables.bbox, jt.BoundingBoxFactors, 5)
    out = fac.bbox_residuals_and_jac(to_port(state), to_port(cams), to_port(f))
    _check_outputs(out, jax_bbox_jacfwd(state, cams, f), K2_TOL, "vs XLA jacfwd")
    _check_outputs(
        out, bbox_residuals_and_jac_pallas(state, cams, f, interpret=True), K2_TOL,
        "vs Pallas interpret",
    )
    live = np.asarray(f.mask)
    for a in out:
        assert np.array_equal(npy(a)[~live], np.zeros_like(npy(a)[~live]))


def test_bbox_invalid_projection_saturates():
    """Camera inside the ellipsoid: residual pinned at invalid_error and
    Jacobians exactly zero, as the reference."""
    state, _, cams, tables, *_ = jax_problem(
        n_poses=4, n_points=16, n_objects=1, obs_per_object=4, seed=7
    )
    objects = np.asarray(state.objects).copy()
    objects[0, :3] = np.asarray(state.poses)[0, :3]
    objects[0, 4:7] = 50.0
    state = state._replace(objects=objects)
    r, j_obj, j_pose = fac.bbox_residuals_and_jac(
        to_port(state), to_port(cams), to_port(tables.bbox)
    )
    live = np.asarray(tables.bbox.mask)
    invalid = live & np.all(npy(r) == 1e6, axis=1)
    assert invalid.any(), "expected at least one invalid projection"
    for j in (j_obj, j_pose):
        assert np.array_equal(npy(j)[invalid], np.zeros_like(npy(j)[invalid]))
    _check_outputs(
        (r, j_obj, j_pose),
        bbox_residuals_and_jac_pallas(state, cams, tables.bbox, interpret=True),
        K2_TOL, "saturated",
    )


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    state, _, cams, tables, *_ = jax_problem(n_poses=12, n_points=48, n_objects=4, seed=4)
    s, c = to_port(state), to_port(cams)
    ops.reset_kernel_launches()
    for a, b in zip(
        ops.reproj_residuals_and_jac(s, c, to_port(tables.reproj)),
        fac.reproj_residuals_and_jac_fast(s, c, to_port(tables.reproj)),
    ):
        assert torch.equal(a, b)
    for a, b in zip(
        ops.bbox_residuals_and_jac(s, c, to_port(tables.bbox)),
        fac.bbox_residuals_and_jac(s, c, to_port(tables.bbox)),
    ):
        assert torch.equal(a, b)
    w_rows, local_pose = (torch.from_numpy(x) for x in _band_inputs(1, 64, 4, np.float64))
    for a, b in zip(
        ops.band_zbuild_gram(w_rows, local_pose),
        band_gram.band_zbuild_gram_plain(w_rows, local_pose),
    ):
        assert torch.equal(a, b)
    assert torch.equal(ops.syrk_gram(w_rows[0]), syrk.syrk_gram_plain(w_rows[0]))
    assert ops.kernel_launches() == {"reproj": 0, "bbox": 0, "band_gram": 0, "syrk": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    state, _, cams, tables, *_ = jax_problem(n_poses=4, n_points=16, n_objects=1, seed=7)
    s = to_port(state)
    s = s._replace(poses=s.poses.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.reproj_residuals_and_jac(s, to_port(cams), to_port(tables.reproj))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.bbox_residuals_and_jac(s, to_port(cams), to_port(tables.bbox))
    w_rows, local_pose = (
        torch.from_numpy(x).to("meta") for x in _band_inputs(1, 64, 4, np.float32)
    )
    with pytest.raises(ValueError, match="unsupported device"):
        ops.band_zbuild_gram(w_rows, local_pose)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.syrk_gram(w_rows[0])
    assert ops.kernel_launches() == {"reproj": 0, "bbox": 0, "band_gram": 0, "syrk": 0}


def _band_inputs(n_group, k_rows, n_slot, dtype, seed=0):
    """K3 operands: w_rows (G, K, 6C) and local_pose (G, K, C) with distinct
    local poses per row, except rows 3, 4 and 5 (mod 8), which repeat a pose
    (summed) or hold dead slots (128)."""
    rng = np.random.default_rng(seed)
    w_rows = (rng.normal(size=(n_group, k_rows, 6 * n_slot))
              * rng.lognormal(0, 1, (n_group, k_rows, 6 * n_slot))).astype(dtype)
    local = np.stack([
        np.stack([rng.choice(128, n_slot, replace=False) for _ in range(k_rows)])
        for _ in range(n_group)
    ]).astype(np.int32)
    rows = np.arange(k_rows) % 8
    local[:, rows == 3, 1] = local[:, rows == 3, 0]
    local[:, rows == 4, 2:] = 128
    local[:, rows == 5, :] = 128
    return w_rows, local


def _unique_rows(local):
    live = np.where(local < 128, local, -1 - np.arange(local.shape[-1]))
    return np.array([[len(set(r)) == len(r) for r in g] for g in live])


def test_band_gram_plain_matches_pallas_f32():
    """z equal bit for bit where each row's live local poses are distinct
    (one product per entry); s within 1e-5 of its largest entry (the Pallas
    kernel's 3-part bf16 split against FP32 sums)."""
    w_rows, local = _band_inputs(2, 512, 6, np.float32, seed=1)
    z_ref, s_ref = band_gram_pallas.band_zbuild_gram(
        jnp.asarray(w_rows), jnp.asarray(local), parts=3, interpret=True
    )
    z, s = band_gram.band_zbuild_gram_plain(torch.from_numpy(w_rows), torch.from_numpy(local))
    assert z.dtype == s.dtype == torch.float32
    unique = _unique_rows(local)
    assert unique.sum() > 0.8 * unique.size and not unique.all()
    np.testing.assert_array_equal(npy(z)[unique], np.asarray(z_ref)[unique])
    s_ref = np.asarray(s_ref)
    assert np.abs(npy(s) - s_ref).max() <= 1e-5 * np.abs(s_ref).max()


def test_band_gram_plain_matches_numpy_f64():
    w_rows, local = _band_inputs(3, 200, 5, np.float64, seed=2)
    onehot = (local[..., None] == np.arange(128)).astype(np.float64)  # (G, K, C, 128)
    z_ref = np.einsum("gksc,gksp->gkcp", w_rows.reshape(3, 200, 5, 6), onehot).reshape(3, 200, 768)
    s_ref = np.einsum("gki,gkj->gij", z_ref, z_ref)
    z, s = band_gram.band_zbuild_gram_plain(torch.from_numpy(w_rows), torch.from_numpy(local))
    np.testing.assert_allclose(npy(z), z_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(npy(s), s_ref, rtol=1e-12, atol=1e-12 * np.abs(s_ref).max())


def _syrk_operand(dtype):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1024, 768)) * rng.lognormal(0, 2, (1024, 768))).astype(dtype)


def test_syrk_plain_matches_pallas_f32():
    """Against the 3-part split kernel mirrored to a full matrix: rtol 1e-5,
    with an absolute floor of 1e-5 of the largest entry for entries that
    cancel."""
    c = _syrk_operand(np.float32)
    ref = np.asarray(syrk_pallas.mirror_lower(
        syrk_pallas.syrk_lower_split(jnp.asarray(c), parts=3, interpret=True)
    ))
    s = npy(syrk.syrk_gram_plain(torch.from_numpy(c)))
    assert s.dtype == np.float32
    np.testing.assert_allclose(s, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_syrk_plain_matches_numpy_f64():
    c = _syrk_operand(np.float64)
    ref = c.T @ c
    s = npy(syrk.syrk_gram_plain(torch.from_numpy(c)))
    np.testing.assert_allclose(s, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
