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
from obvi_slam_tpu_torch.ops import _gram, band_gram, syrk
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


# ---- numpy models of the CUDA gram kernels' tile walks ---------------------
# Each model follows its kernel's tile walk step by step (plans, masks, pair
# enumeration, split bounds, in-order compaction, per-tile products,
# fixed-order reduction, mirror) and is held against the plain version at
# f64 (rtol 1e-12). This checks the wrappers' plans and the index arithmetic
# (ops/_gram.py), not the CUDA code: chip_smoke.py holds the kernels
# themselves against the plain versions on the card, edge operands included.


def syrk_tile_walk_model(c):
    """csrc/syrk.cu on C (K, M): returns (S, rows multiplied per tile pair)."""
    k_rows, m = c.shape
    p = syrk.plan(k_rows, m)
    t = syrk.TILE
    # Pass 1: bit (panel % 32) of word panel // 32 marks a non-zero in the panel.
    mask = np.zeros((k_rows, p.words), np.uint32)
    for panel in range(p.tiles):
        nz = (c[:, panel * t:(panel + 1) * t] != 0).any(1).astype(np.uint32)
        mask[:, panel // 32] |= nz << np.uint32(panel % 32)
    cz = np.zeros((k_rows, p.tiles * t), c.dtype)  # columns past M read as 0
    cz[:, :m] = c
    # Pass 2: block (pair, split) compacts its rows chunk by chunk, in order.
    flags = np.zeros((p.pairs, p.splits), bool)
    partials = np.zeros((p.pairs, p.splits, t, t), c.dtype)
    rows = np.zeros(p.pairs, np.int64)
    for rank in range(p.pairs):  # grid order: diagonal first
        ti, tj = _gram.diag_pair(rank, p.tiles)
        pair = ti * (ti + 1) // 2 + tj
        assert _gram.lower_pair(pair) == (ti, tj)
        for split in range(p.splits):
            r_begin = split * p.split_rows
            r_end = min(k_rows, r_begin + p.split_rows)
            acc = np.zeros((t, t), c.dtype)
            total = 0
            for chunk in range(r_begin, r_end, 256):
                r = np.arange(chunk, min(chunk + 256, r_end))
                ok = ((mask[r, ti // 32] >> np.uint32(ti % 32)) & 1).astype(bool)
                ok &= ((mask[r, tj // 32] >> np.uint32(tj % 32)) & 1).astype(bool)
                for row in r[ok]:
                    acc += np.outer(cz[row, ti * t:(ti + 1) * t], cz[row, tj * t:(tj + 1) * t])
                total += int(ok.sum())
            flags[pair, split] = total > 0
            if total:
                partials[pair, split] = acc
            rows[pair] += total
    # Pass 3: flagged partials summed in split order; tile and mirror written.
    s = np.full((m, m), np.nan, c.dtype)
    for pair in range(p.pairs):
        ti, tj = _gram.lower_pair(pair)
        acc = np.zeros((t, t), c.dtype)
        for split in range(p.splits):
            if flags[pair, split]:
                acc = acc + partials[pair, split]
        i = np.arange(ti * t, min(m, (ti + 1) * t))
        j = np.arange(tj * t, min(m, (tj + 1) * t))
        s[np.ix_(i, j)] = acc[:len(i), :len(j)]
        s[np.ix_(j, i)] = acc[:len(i), :len(j)].T
    return s, rows


def band_gram_tile_walk_model(w_rows, local_pose):
    """csrc/band_gram.cu on (w_rows, local_pose): returns (z, s, rows
    multiplied per (group, lower panel pair))."""
    n_group, k_rows, c6 = w_rows.shape
    n_slot = c6 // 6
    p = band_gram.plan(n_group, k_rows)
    pw, width = band_gram.PANEL, band_gram.WIDTH
    cols = 6 * pw
    # z blocks: every row written once; each entry sums its slots in order.
    z = np.zeros((n_group, k_rows, band_gram.WBAND), w_rows.dtype)
    for sl in range(n_slot):
        lp = local_pose[..., sl]
        gg, rr = np.nonzero((lp >= 0) & (lp < width))
        for c in range(6):
            z[gg, rr, c * width + lp[gg, rr]] += w_rows[gg, rr, 6 * sl + c]

    def bits(g, r, panel):
        d = local_pose[g, r] - panel * pw
        return np.isin(np.arange(pw), d[(d >= 0) & (d < pw)])

    def z_slice(g, r, panel):
        """(6, 16) z slice of a panel built from w_rows, never from z."""
        out = np.zeros((6, pw), w_rows.dtype)
        for sl in range(n_slot):
            d = local_pose[g, r, sl] - panel * pw
            if 0 <= d < pw:
                out[:, d] += w_rows[g, r, 6 * sl:6 * sl + 6]
        return out

    flags = np.zeros((n_group, band_gram.PAIRS, p.splits), bool)
    partials = np.zeros((n_group, band_gram.PAIRS, p.splits, cols, cols), w_rows.dtype)
    rows = np.zeros((n_group, band_gram.PAIRS), np.int64)
    for g in range(n_group):
        for pair in range(band_gram.PAIRS):
            pi, pj = _gram.lower_pair(pair)
            for split in range(p.splits):
                r_begin = split * p.split_rows
                r_end = min(k_rows, r_begin + p.split_rows)
                acc = np.zeros((cols, cols), w_rows.dtype)
                total = 0
                for chunk in range(r_begin, r_end, 256):
                    for r in range(chunk, min(chunk + 256, r_end)):
                        bi, bj = bits(g, r, pi), bits(g, r, pj)
                        if not (bi.any() and bj.any()):
                            continue
                        total += 1
                        # Warp w (poses p = 2w, 2w + 1 of panel pi) adds the
                        # row's products for its threads (p, q) if the row
                        # has a live slot at 2w or 2w + 1.
                        warp_live = bi.reshape(8, 2).any(1).repeat(2)
                        rows_live = np.tile(warp_live, 6)[:, None]
                        prod = np.outer(z_slice(g, r, pi).ravel(), z_slice(g, r, pj).ravel())
                        acc += np.where(rows_live, prod, 0)
                flags[g, pair, split] = total > 0
                if total:
                    partials[g, pair, split] = acc
                rows[g, pair] += total
    s = np.full((n_group, band_gram.WBAND, band_gram.WBAND), np.nan, w_rows.dtype)
    comp = np.arange(6)[:, None] * width
    for g in range(n_group):
        for pair in range(band_gram.PAIRS):
            pi, pj = _gram.lower_pair(pair)
            acc = np.zeros((cols, cols), w_rows.dtype)
            for split in range(p.splits):
                if flags[g, pair, split]:
                    acc = acc + partials[g, pair, split]
            # Tile row c*16 + p is s row c*128 + 16 pi + p (c-major).
            i = (comp + pi * pw + np.arange(pw)).ravel()
            j = (comp + pj * pw + np.arange(pw)).ravel()
            s[g][np.ix_(i, j)] = acc
            s[g][np.ix_(j, i)] = acc.T
    return z, s, rows


def _captured(name, size):
    """The operands one CPU compute_step hands the ops wrapper ``name``."""
    from obvi_slam_tpu_torch import compute_step, synthetic_problem

    seen = []
    inner = getattr(ops, name)

    def spy(*args):
        seen.append(args)
        return inner(*args)

    setattr(ops, name, spy)
    try:
        state, _, cams, tables, plan, free, weights, huber = synthetic_problem(**size, device="cpu")
        compute_step(state, cams, tables, plan, free, weights, 1e4, huber)
    finally:
        setattr(ops, name, inner)
    assert len(seen) == 1
    return tuple(npy(a) for a in seen[0])


def _syrk_case(name):
    rng = np.random.default_rng(3)
    if name == "dense-ragged":
        return rng.normal(size=(300, 200)) + np.where(rng.uniform(size=(300, 200)) < 0.5, 3, -3)
    if name == "sparse-ragged":
        c = rng.normal(size=(700, 150)) * (rng.uniform(size=(700, 150)) < 0.03)
        c[::7] = 0.0  # all-zero rows
        return c
    if name in ("captured", "captured-permuted"):
        (c,) = _captured("syrk_gram", dict(
            n_poses=64, n_points=1024, n_objects=8, obs_per_point=4, obs_per_object=6))
        return c[rng.permutation(len(c))] if name.endswith("permuted") else c
    if name == "K=0":
        return np.zeros((0, 70))
    return rng.normal(size=(50, 10))  # "M<64": one ragged tile


@pytest.mark.parametrize(
    "case", ["dense-ragged", "sparse-ragged", "captured", "captured-permuted", "K=0", "M<64"]
)
def test_syrk_tile_walk_model_matches_plain(case):
    c = _syrk_case(case)
    s, rows = syrk_tile_walk_model(c)
    ref = npy(syrk.syrk_gram_plain(torch.from_numpy(c)))
    assert np.array_equal(s, s.T)
    np.testing.assert_allclose(s, ref, rtol=1e-12, atol=1e-12 * max(np.abs(ref).max(initial=0), 1))
    t = syrk.TILE
    panel = np.stack([(c[:, i:i + t] != 0).any(1) for i in range(0, c.shape[1], t)], 1)
    pairs = [_gram.lower_pair(x) for x in range(len(rows))]
    np.testing.assert_array_equal(rows, [(panel[:, i] & panel[:, j]).sum() for i, j in pairs])


def _band_case(name):
    if name == "edge":
        w_rows, local = _band_inputs(2, 600, 6, np.float64, seed=5)
        rows = np.arange(600) % 8
        local[:, rows == 6, 0] = -1  # dead slots outside [0, 128) other than 128
        local[:, rows == 6, -1] = 200
        return w_rows, local
    if name == "captured":
        return _captured("band_zbuild_gram", dict(
            n_poses=256, n_points=384, n_objects=4, obs_per_point=6, obs_per_object=6))
    if name == "all-dead":
        w_rows, local = _band_inputs(1, 40, 3, np.float64, seed=6)
        return w_rows, np.full_like(local, 128)
    return np.zeros((2, 0, 36)), np.zeros((2, 0, 6), np.int32)  # "K=0"


@pytest.mark.parametrize("case", ["edge", "captured", "all-dead", "K=0"])
def test_band_gram_tile_walk_model_matches_plain(case):
    w_rows, local = _band_case(case)
    z, s, rows = band_gram_tile_walk_model(w_rows, local)
    z_ref, s_ref = (npy(x) for x in band_gram.band_zbuild_gram_plain(
        torch.from_numpy(w_rows), torch.from_numpy(local)))
    dead = ((local < 0) | (local >= band_gram.WIDTH)).all(-1)
    assert np.array_equal(z[dead], np.zeros_like(z[dead]))
    assert np.array_equal(s, s.transpose(0, 2, 1))
    np.testing.assert_allclose(z, z_ref, rtol=1e-12, atol=0)
    atol = 1e-12 * max(np.abs(s_ref).max(initial=0), 1)
    np.testing.assert_allclose(s, s_ref, rtol=1e-12, atol=atol)
    hit = np.stack([((local >= q * band_gram.PANEL) & (local < (q + 1) * band_gram.PANEL))
                    .any(-1) for q in range(band_gram.PANELS)], -1)  # (G, K, panels)
    pairs = [_gram.lower_pair(x) for x in range(band_gram.PAIRS)]
    np.testing.assert_array_equal(
        rows, np.stack([(hit[..., i] & hit[..., j]).sum(1) for i, j in pairs], -1))


def test_gram_plans_fill_the_card_at_the_main_path_shapes():
    """At the window's C (12288 x 384) and the global problem's operands
    (G = 4, K = 3840), each gram launches more blocks than the H100's 132
    SMs; splits cover every row; K = 0 launches no gram block."""
    p4 = syrk.plan(12288, 384)
    assert (p4.tiles, p4.pairs, p4.words, p4.splits, p4.split_rows) == (6, 21, 1, 48, 256)
    assert p4.pairs * p4.splits == 1008 and p4.splits * p4.split_rows >= 12288
    p3 = band_gram.plan(4, 3840)
    assert (p3.splits, p3.split_rows, band_gram.PAIRS * p3.splits * 4) == (8, 512, 1152)
    assert p3.splits * p3.split_rows >= 3840 > (p3.splits - 1) * p3.split_rows
    assert syrk.plan(0, 70).splits == band_gram.plan(2, 0).splits == 0
    for n in (1, 6, 8):  # the gram grid's diagonal-first order covers each pair once
        pairs = n * (n + 1) // 2
        order = [_gram.diag_pair(t, n) for t in range(pairs)]
        assert sorted(order) == sorted(_gram.lower_pair(t) for t in range(pairs))
        assert [i - j for i, j in order] == sorted(i - j for i, j in order)
    big = syrk.plan(10**6, 4096)  # partial tiles stay capped
    assert big.pairs * big.splits <= syrk.MAX_PARTIALS
    assert big.splits * big.split_rows >= 10**6


# ---- numpy models of the factor kernels' lane map and staged stores --------
# K2 (csrc/bbox.cu) runs a half-warp per factor, lane k < 7 on column k of
# J_obj, lane 7 + m on column m of J_pose, lane 13 on the residual; each lane
# stages its 4 values in the block's records, which the block writes back as
# its contiguous output slices. K1 (csrc/reproj.cu) stages each thread's 20
# outputs the same way. The models below follow that index arithmetic and
# must reassemble the plain versions' outputs exactly. They check the lane
# map, the record offsets and the write-back (16-byte body, ragged tail)
# only, not the CUDA code: chip_smoke.py holds the kernels themselves against
# the plain versions on the card.

import re  # noqa: E402
from pathlib import Path  # noqa: E402

from obvi_slam_tpu_torch.ops import bbox as k_bbox  # noqa: E402
from obvi_slam_tpu_torch.ops import reproj as k_reproj  # noqa: E402

_CSRC = Path(k_reproj.__file__).resolve().parent / "csrc"


def stage_store_model(dst, offset, src, count, threads, vec):
    """factor_common.cuh::store_slice: thread t writes 16-byte vectors (vec
    values) t, t + threads, ... of the body, then values body + t, ... of the
    ragged tail.
    Returns how often each value of dst[offset:offset + count] was written."""
    written = np.zeros(count, np.int64)
    body = count // vec
    for t in range(threads):
        for v in range(t, body, threads):
            dst[offset + v * vec:offset + (v + 1) * vec] = src[v * vec:(v + 1) * vec]
            written[v * vec:(v + 1) * vec] += 1
        for k in range(body * vec + t, count, threads):
            dst[offset + k] = src[k]
            written[k] += 1
    return written


def bbox_lane_values(r, j_obj, j_pose, f):
    """The (16, 4) values of factor f's lanes (NaN for the idle lanes 14-15)."""
    lanes = np.full((k_bbox.LANES, 4), np.nan)
    for lane in range(k_bbox.LANES):
        if lane < 7:
            lanes[lane] = j_obj[f, :, lane]
        elif lane < k_bbox.RESIDUAL_LANE:
            lanes[lane] = j_pose[f, :, lane - 7]
        elif lane == k_bbox.RESIDUAL_LANE:
            lanes[lane] = r[f]
    return lanes


def bbox_stage_model(r, j_obj, j_pose, vec):
    """csrc/bbox.cu's lane map, records and write-back, block by block."""
    n, per = r.shape[0], k_bbox.FACTORS_PER_BLOCK
    threads = k_bbox.LANES * per
    outs = [np.full(n * w, np.nan) for w in (4, 28, 24)]
    written = [np.zeros(n * w, np.int64) for w in (4, 28, 24)]
    for f0 in range(0, n, per):
        nf = min(per, n - f0)
        recs = [np.full(per * w, np.nan) for w in (4, 28, 24)]
        for slot in range(nf):
            lanes = bbox_lane_values(r, j_obj, j_pose, f0 + slot)
            for lane in range(k_bbox.RESIDUAL_LANE + 1):
                if lane < 7:
                    rec, base, stride = recs[1], 28 * slot + lane, 7
                elif lane < k_bbox.RESIDUAL_LANE:
                    rec, base, stride = recs[2], 24 * slot + lane - 7, 6
                else:
                    rec, base, stride = recs[0], 4 * slot, 1
                for i in range(4):
                    rec[base + stride * i] = lanes[lane, i]
        for out, rec, w, cnt in zip(outs, recs, (4, 28, 24), written):
            cnt[w * f0:w * (f0 + nf)] += stage_store_model(
                out, w * f0, rec, w * nf, threads, vec)
    assert all((c == 1).all() for c in written), "every output value written once"
    return outs[0].reshape(n, 4), outs[1].reshape(n, 4, 7), outs[2].reshape(n, 4, 6)


def reproj_stage_model(r, j_pose, j_point, vec):
    """csrc/reproj.cu's per-thread records and write-back, block by block."""
    n, threads = r.shape[0], k_reproj.THREADS
    widths = (2, 12, 6)
    outs = [np.full(n * w, np.nan) for w in widths]
    written = [np.zeros(n * w, np.int64) for w in widths]
    flat = [r.reshape(n, 2), j_pose.reshape(n, 12), j_point.reshape(n, 6)]
    for f0 in range(0, n, threads):
        nf = min(threads, n - f0)
        for out, src, w, cnt in zip(outs, flat, widths, written):
            rec = np.full(threads * w, np.nan)
            for t in range(nf):
                rec[w * t:w * (t + 1)] = src[f0 + t]
            cnt[w * f0:w * (f0 + nf)] += stage_store_model(
                out, w * f0, rec, w * nf, threads, vec)
    assert all((c == 1).all() for c in written), "every output value written once"
    return outs[0].reshape(n, 2), outs[1].reshape(n, 2, 6), outs[2].reshape(n, 2, 3)


def test_factor_kernel_constants_match_sources():
    """The Python twins of the kernels' launch constants."""
    def constexpr(src, name):
        text = (_CSRC / src).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert constexpr("reproj.cu", "kThreads") == k_reproj.THREADS
    assert constexpr("bbox.cu", "kLanes") == k_bbox.LANES
    assert constexpr("bbox.cu", "kFactorsPerBlock") == k_bbox.FACTORS_PER_BLOCK
    assert constexpr("bbox.cu", "kResidualLane") == k_bbox.RESIDUAL_LANE
    assert k_bbox.RESIDUAL_LANE == 7 + 6 < k_bbox.LANES <= 32


def _plain_factor_outputs(n_extra):
    """Plain K1/K2 outputs on a small problem whose tables get ``n_extra``
    masked garbage rows: (reproj outputs, bbox outputs) as numpy."""
    state, _, cams, tables, *_ = jax_problem(
        n_poses=12, n_points=48, n_objects=4, obs_per_object=10, seed=4)
    rp = _garbage_padded(tables.reproj, jt.ReprojectionFactors, n_extra)
    bb = _garbage_padded(tables.bbox, jt.BoundingBoxFactors, n_extra % 7)
    s, c = to_port(state), to_port(cams)
    return (tuple(npy(x) for x in fac.reproj_residuals_and_jac_fast(s, c, to_port(rp))),
            tuple(npy(x) for x in fac.bbox_residuals_and_jac(s, c, to_port(bb))))


@pytest.mark.parametrize("vec", [4, 2], ids=["f32", "f64"])
@pytest.mark.parametrize("n_extra", [0, 37])
def test_factor_stage_models_reassemble_plain(vec, n_extra):
    """The lane map and staged records written back block by block give the
    plain versions' outputs bit for bit, each value written once, with a
    ragged last block for K1 and K2."""
    rp_out, bb_out = _plain_factor_outputs(n_extra)
    n_rp, n_bb = rp_out[0].shape[0], bb_out[0].shape[0]
    if n_extra:
        assert n_rp % k_reproj.THREADS and n_bb % k_bbox.FACTORS_PER_BLOCK, "ragged"
    for got, want in zip(reproj_stage_model(*rp_out, vec), rp_out):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(bbox_stage_model(*bb_out, vec), bb_out):
        np.testing.assert_array_equal(got, want)


def _pose_rotation_model(w):
    """factor_common.cuh::pose_rotation for one axis-angle w (numpy f64):
    R^T = I - a S + b S^2, Jr = I - b S + c S^2."""
    wx, wy, wz = w
    theta2 = wx * wx + wy * wy + wz * wz
    if theta2 < 1e-16:
        a, b, c = 1 - theta2 / 6, 0.5 - theta2 / 24, 1 / 6 - theta2 / 120
    else:
        theta = np.sqrt(theta2)
        s = np.sin(theta)
        a, b, c = s / theta, (1 - np.cos(theta)) / theta2, (theta - s) / (theta2 * theta)
    sk = np.array([[0, -wz, wy], [wz, 0, -wx], [-wy, wx, 0]])
    s2 = sk @ sk
    return np.eye(3) - a * sk + b * s2, np.eye(3) - b * sk + c * s2


def test_pose_rotation_model_matches_plain_tables():
    """The kernels' per-factor rotation formulas against the plain versions'
    R^T and Jr (geometry.exp_so3 / right_jacobian_so3), at large, small
    (Taylor branch) and zero angles."""
    rng = np.random.default_rng(11)
    w = np.concatenate([
        rng.normal(size=(20, 3)) * 1.5,
        rng.normal(size=(6, 3)) * 1e-3,
        rng.normal(size=(4, 3)) * 1e-9,  # theta^2 < 1e-16: Taylor terms
        np.zeros((1, 3)),
    ])
    poses = torch.from_numpy(np.concatenate([rng.normal(size=(len(w), 3)), w], 1))
    rt, jr = (npy(x) for x in fac.pose_rotation_tables(poses))
    for k, wk in enumerate(w):
        rt_k, jr_k = _pose_rotation_model(wk)
        np.testing.assert_allclose(rt_k, rt[k], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(jr_k, jr[k], rtol=1e-12, atol=1e-15)


def test_reproj_plain_depth_zero_matches_jax():
    """At a camera depth of exactly 0 (zero pose, identity camera, point at
    the camera centre) the plain K1 maps |z| < 1e-300 to 1e-300, as the JAX
    XLA path: finite outputs, equal to the reference's."""
    zeros = np.zeros
    state = jt.BAState(poses=zeros((1, 6)), points=zeros((1, 3)), objects=zeros((1, 7)))
    cams = jt.CameraBundle(
        cam_from_robot_r=np.eye(3)[None], cam_from_robot_t=zeros((1, 3)),
        fx=np.array([500.0]), fy=np.array([500.0]), cx=np.array([320.0]),
        cy=np.array([240.0]),
    )
    idx = zeros(1, np.int32)
    f = jt.ReprojectionFactors(
        pose_idx=idx, point_idx=idx, cam_idx=idx, rect_obs=np.array([[0.25, -0.5]]),
        multiplier=np.array([[2.0, 3.0]]), mask=np.ones(1, bool),
    )
    out = fac.reproj_residuals_and_jac_fast(to_port(state), to_port(cams), to_port(f))
    assert all(np.isfinite(npy(x)).all() for x in out)
    np.testing.assert_array_equal(npy(out[0]), [[-0.5, 1.5]])
    np.testing.assert_allclose(npy(out[2])[0, 0, 0], 2.0 / 1e-300, rtol=1e-15)
    _check_outputs(out, jax_reproj_fast(state, cams, f), K1_TOL, "depth 0")
