"""One damped Gauss-Newton (LM) step by Schur complement, dense slot-gram path.

Counterpart of ``obvi_slam_tpu/solver/schur.py::compute_step`` with
``dense_schur=True`` and no band layout: points (3-D) and objects (7-dof
ellipsoids) are eliminated through batched small-block inverses, and the
reduced pose system S (6P x 6P) is assembled from three grams and solved
densely:

  residuals + J (kernels K1, K2) -> Huber row weights -> H/b block sums
  -> LM damping -> 3x3 / 7x7 SPD inverse and factor G (H^-1 = G G^T)
  -> W pair blocks -> slot grams (W G)(W G)^T for points and objects
  -> S = V_rel V_rel^T - grams -> Cholesky + one refinement step
  -> back-substitution -> model cost change.

Grams are plain float32/float64 matmuls; on the card TF32 must stay off
(``torch.backends.cuda.matmul.allow_tf32 = False``), which the caller sets.
Paths this port does not have yet (the pair-enumeration path, the banded
layouts, a slot grid over budget) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import geometry as geo
from obvi_slam_tpu_torch import ops
from obvi_slam_tpu_torch.types import BAState


class FactorWeights(NamedTuple):
    """Per-residual-block external weights (1 = keep, 0 = excluded)."""

    reproj: torch.Tensor  # (F,)
    bbox: torch.Tensor  # (B,)
    shape: torch.Tensor  # (S,)
    relpose: torch.Tensor  # (R,)
    ltm: torch.Tensor  # (L,)


def ones_weights(tables, dtype=torch.float64):
    device = tables.reproj.mask.device

    def ones(t):
        return torch.ones(t.capacity, dtype=dtype, device=device)

    return FactorWeights(
        reproj=ones(tables.reproj),
        bbox=ones(tables.bbox),
        shape=ones(tables.shape),
        relpose=ones(tables.relpose),
        ltm=ones(tables.ltm),
    )


class HuberParams(NamedTuple):
    """Loss scale per family."""

    reproj: float = 1.0
    bbox: float = 0.5
    shape: float = 10.0
    relpose: float = 1.0
    ltm: float = 1.0
    invalid_ellipse_error: float = 1e6


# Ceres LevenbergMarquardtStrategy diagonal clamping.
_MIN_DIAG = 1e-6
_MAX_DIAG = 1e32
# Largest one-hot slot grid (elements) the reference builds before it falls
# back to its pair-scatter path.
_SLOT_BUDGET = 48 * 1024 * 1024


def _outer_rr(a, b):
    """(F, r, i), (F, r, j) -> (F, i, j) = sum_r a b."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(1)


def _jtr(j, r):
    """(F, r, i), (F, r) -> (F, i) = J^T r."""
    return (j * r[:, :, None]).sum(1)


def _segment_sum(vals, idx, n):
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add_(0, idx.long(), vals)


def _hb_pack(j, r):
    """[J^T J | -J^T r] flattened per factor."""
    d = j.shape[-1]
    return torch.cat([_outer_rr(j, j).reshape(-1, d * d), -_jtr(j, r)], 1)


def _cholesky_clamped(a):
    """Batched Cholesky of SPD (B, n, n) blocks, column by column, with the
    pivot clamped at 1e-30 (never fails, as the reference's unrolled form)."""
    n = a.shape[-1]
    low = torch.zeros_like(a)
    for j in range(n):
        d = a[:, j, j] - (low[:, j, :j] * low[:, j, :j]).sum(-1)
        ljj = torch.sqrt(torch.clamp(d, min=1e-30))
        low[:, j, j] = ljj
        if j + 1 < n:
            s = a[:, j + 1:, j] - (low[:, j + 1:, :j] * low[:, j, None, :j]).sum(-1)
            low[:, j + 1:, j] = s / ljj[:, None]
    return low


def _spd_inverse_and_factor(a):
    """Batched SPD inverse of (B, n, n) blocks plus G with A^-1 = G G^T
    (G = L^-T from A = L L^T)."""
    low = _cholesky_clamped(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    g = torch.linalg.solve_triangular(low, eye, upper=False).transpose(-1, -2)
    return (g[:, :, None, :] * g[:, None, :, :]).sum(-1), g


def _block_weight(r, delta, ext_weight, mask):
    """sqrt(rho') * external weight * mask: the row scale of r and J."""
    return fac.huber_sqrt_weight((r * r).sum(-1), delta) * ext_weight * mask


def _diag(h):
    return torch.diagonal(h, dim1=-2, dim2=-1)


def _slot_gram(w_scaled, slot_gather, slot_pose, slot_mask, n_pose):
    """Schur subtraction sum_l (W_l G_l)(W_l G_l)^T through the slot grid.

    Each live slot (l, c) places its (6, bw) pair block at pose row
    slot_pose[l, c] of landmark l; (pose, landmark) pairs are unique, so every
    entry of z receives one block (dead slots add zeros). Returns S_sub
    (6P, 6P) and z flattened to rows (landmark, block column) by columns
    (pose, component)."""
    n_land, n_slot = slot_gather.shape
    bw = w_scaled.shape[-1]
    w_comp = w_scaled.reshape(-1, 6 * bw)[slot_gather.reshape(-1).long()]
    w_comp = w_comp * slot_mask.reshape(-1, 1).to(w_comp.dtype)
    land = torch.arange(n_land, device=slot_pose.device)[:, None]
    rows = (land * n_pose + slot_pose.long()).reshape(-1)
    z = w_scaled.new_zeros((n_land * n_pose, 6 * bw)).index_add_(0, rows, w_comp)
    zf = z.reshape(n_land, n_pose, 6, bw).permute(0, 3, 1, 2).reshape(
        n_land * bw, n_pose * 6
    )
    return zf.T @ zf, zf


def _dense_from_pairs(row_blk, col_blk, live, blocks, n_pose, n_col):
    """Dense (6P, 6 n_col) block matrix with block (row_blk[k], col_blk[k])
    = blocks[k]; dead rows land on a spare block row that is dropped."""
    k = blocks.shape[0]
    device = blocks.device
    ar = torch.arange(6, device=device)
    rows = torch.where(live, row_blk.long(), n_pose)[:, None] * 6 + ar
    cols = col_blk.long()[:, None] * 6 + ar
    out = blocks.new_zeros(((n_pose + 1) * 6, n_col * 6))
    out[rows[:, :, None].expand(k, 6, 6), cols[:, None, :].expand(k, 6, 6)] = blocks
    return out[: n_pose * 6]


def compute_step(
    state: BAState,
    cams,
    tables,
    plan,
    free,
    weights: FactorWeights,
    radius,
    huber: HuberParams = HuberParams(),
    dense_schur: bool = True,
    plain: bool = False,
):
    """One LM step: returns (delta: BAState, model_cost_change, grad_max),
    the last two as 0-dim tensors.

    The trust-region radius enters as Ceres' damping
    H + diag(clamp(diag(H))) / radius. ``plain`` evaluates K1/K2 with their
    plain PyTorch versions on any device (reference runs); otherwise the
    wrappers launch the CUDA kernels for CUDA tensors."""
    if not dense_schur:
        raise NotImplementedError("the pair-enumeration Schur path is not ported")
    if plan.pt_band_local_pose is not None or plan.rel_band_gather is not None:
        raise NotImplementedError("the banded Schur layout is not ported")
    dtype = state.poses.dtype
    n_pose = state.poses.shape[0]
    n_point = state.points.shape[0]
    n_obj = state.objects.shape[0]
    for kind, slot_gather in (("point", plan.pt_slot_gather), ("object", plan.ob_slot_gather)):
        if slot_gather.shape[0] * slot_gather.shape[1] * n_pose > _SLOT_BUDGET:
            raise NotImplementedError(
                f"{kind} slot grid over budget: the scatter fallback is not ported"
            )

    pose_free = free.poses.to(dtype)
    point_free = free.points.to(dtype)
    obj_free = free.objects.to(dtype)
    rp, bb, sh, rl, lt, pp = tables

    # ---- residuals + Jacobians, robustified ------------------------------
    if plain:
        r_rp, j_rp_pose, j_rp_point = fac.reproj_residuals_and_jac_fast(state, cams, rp)
        r_bb, j_bb_obj, j_bb_pose = fac.bbox_residuals_and_jac(
            state, cams, bb, huber.invalid_ellipse_error
        )
    else:
        r_rp, j_rp_pose, j_rp_point = ops.reproj_residuals_and_jac(state, cams, rp)
        r_bb, j_bb_obj, j_bb_pose = ops.bbox_residuals_and_jac(
            state, cams, bb, huber.invalid_ellipse_error
        )
    w = _block_weight(r_rp, huber.reproj, weights.reproj, rp.mask.to(dtype))
    r_rp = r_rp * w[:, None]
    j_rp_pose = j_rp_pose * (w * pose_free[rp.pose_idx.long()])[:, None, None]
    j_rp_point = j_rp_point * (w * point_free[rp.point_idx.long()])[:, None, None]

    w = _block_weight(r_bb, huber.bbox, weights.bbox, bb.mask.to(dtype))
    r_bb = r_bb * w[:, None]
    j_bb_obj = j_bb_obj * (w * obj_free[bb.obj_idx.long()])[:, None, None]
    j_bb_pose = j_bb_pose * (w * pose_free[bb.pose_idx.long()])[:, None, None]

    r_sh, j_sh = fac.shape_residuals_and_jac(state, sh)
    w = _block_weight(r_sh, huber.shape, weights.shape, sh.mask.to(dtype))
    r_sh = r_sh * w[:, None]
    j_sh = j_sh * (w * obj_free[sh.obj_idx.long()])[:, None, None]

    r_rl, j_rl_b, j_rl_a = fac.relpose_residuals_and_jac(state, rl)
    w = _block_weight(r_rl, huber.relpose, weights.relpose, rl.mask.to(dtype))
    r_rl = r_rl * w[:, None]
    j_rl_b = j_rl_b * (w * pose_free[rl.before_idx.long()])[:, None, None]
    j_rl_a = j_rl_a * (w * pose_free[rl.after_idx.long()])[:, None, None]

    r_lt, j_lt = fac.ltm_residuals_and_jac(state, lt)
    w = _block_weight(r_lt, huber.ltm, weights.ltm, lt.mask.to(dtype))
    r_lt = r_lt * w[:, None]
    j_lt = j_lt * (w * obj_free[lt.obj_idx.long()])[:, None, None]

    r_pp = fac.param_prior_residuals(state, pp)

    # ---- H/b block sums --------------------------------------------------
    ll_out = _segment_sum(_hb_pack(j_rp_point, r_rp), rp.point_idx, n_point)
    h_ll = ll_out[:, :9].reshape(n_point, 3, 3)
    b_l = ll_out[:, 9:12]
    oo_out = (
        _segment_sum(_hb_pack(j_bb_obj, r_bb), bb.obj_idx, n_obj)
        + _segment_sum(_hb_pack(j_sh, r_sh), sh.obj_idx, n_obj)
        + _segment_sum(_hb_pack(j_lt, r_lt), lt.obj_idx, n_obj)
    )
    h_oo = oo_out[:, :49].reshape(n_obj, 7, 7)
    b_o = oo_out[:, 49:56]
    # The relpose part of H_pp is kept apart: S carries it through V_rel.
    pp_rel_out = _segment_sum(_hb_pack(j_rl_b, r_rl), rl.before_idx, n_pose) + _segment_sum(
        _hb_pack(j_rl_a, r_rl), rl.after_idx, n_pose
    )
    pp_out = (
        _segment_sum(_hb_pack(j_rp_pose, r_rp), rp.pose_idx, n_pose)
        + _segment_sum(_hb_pack(j_bb_pose, r_bb), bb.pose_idx, n_pose)
        + pp_rel_out
    )
    h_pp = pp_out[:, :36].reshape(n_pose, 6, 6)
    h_pp_rel = pp_rel_out[:, :36].reshape(n_pose, 6, 6)
    b_p = pp_out[:, 36:42]

    # ---- scalar parameter priors onto the diagonals ----------------------
    pp_live = pp.mask.to(dtype)
    pp_w2 = pp.inv_std * pp.inv_std * pp_live
    bidx, pidx = pp.block_idx.long(), pp.param_idx.long()
    grad_pp = pp.inv_std * r_pp * pp_live

    def prior_accum(kind, free_mask, n_block, dim, values):
        blk = bidx.clamp(0, n_block - 1)
        sel = (pp.block_kind == kind).to(dtype) * free_mask[blk]
        flat = blk * dim + pidx.clamp(0, dim - 1)
        out = values.new_zeros(n_block * dim).index_add_(0, flat, values * sel)
        return out.reshape(n_block, dim)

    def diag_add(h, vec):
        return h + torch.diag_embed(vec)

    h_pp = diag_add(h_pp, prior_accum(0, pose_free, n_pose, 6, pp_w2))
    h_ll = diag_add(h_ll, prior_accum(1, point_free, n_point, 3, pp_w2))
    h_oo = diag_add(h_oo, prior_accum(2, obj_free, n_obj, 7, pp_w2))
    b_p = b_p + prior_accum(0, pose_free, n_pose, 6, -grad_pp)
    b_l = b_l + prior_accum(1, point_free, n_point, 3, -grad_pp)
    b_o = b_o + prior_accum(2, obj_free, n_obj, 7, -grad_pp)

    grad_max = torch.maximum(
        b_p.abs().max(), torch.maximum(b_l.abs().max(), b_o.abs().max())
    )

    # ---- LM damping: H += diag(clamp(diag(H))) / radius ------------------
    inv_radius = 1.0 / radius

    def clip_diag(h):
        return torch.clamp(_diag(h), _MIN_DIAG, _MAX_DIAG)

    def damp(h):
        return h + torch.diag_embed(clip_diag(h) * inv_radius)

    h_ll_d, h_oo_d, h_pp_d = damp(h_ll), damp(h_oo), damp(h_pp)
    # Unobserved or fixed landmark blocks -> identity (their delta stays 0).
    ll_singular = _diag(h_ll).abs().sum(-1) < 1e-12
    oo_singular = _diag(h_oo).abs().sum(-1) < 1e-12
    eye3 = torch.eye(3, dtype=dtype, device=h_ll.device)
    eye6 = torch.eye(6, dtype=dtype, device=h_ll.device)
    eye7 = torch.eye(7, dtype=dtype, device=h_ll.device)
    h_ll_d = torch.where(ll_singular[:, None, None], eye3, h_ll_d)
    h_oo_d = torch.where(oo_singular[:, None, None], eye7, h_oo_d)
    h_ll_inv, g_ll = _spd_inverse_and_factor(h_ll_d)
    h_oo_inv, g_oo = _spd_inverse_and_factor(h_oo_d)

    # ---- W pair blocks ---------------------------------------------------
    def pair_blocks(j_pose, j_land, pair_factor, factor_pair, pair_mask):
        n_pair, d = pair_mask.shape[0], j_land.shape[-1]
        outer = _outer_rr(j_pose, j_land).reshape(-1, 6 * d)
        if pair_factor is not None:
            w_pair = outer[pair_factor.long()]
        else:
            w_pair = _segment_sum(outer, factor_pair, n_pair)
        return w_pair.reshape(n_pair, 6, d) * pair_mask.to(dtype)[:, None, None]

    w_pt = pair_blocks(
        j_rp_pose, j_rp_point, plan.pt_pair_factor, plan.rp_factor_pair, plan.pt_pair_mask
    )
    w_ob = pair_blocks(
        j_bb_pose, j_bb_obj, plan.ob_pair_factor, plan.bb_factor_pair, plan.ob_pair_mask
    )

    # ---- reduced camera system S -----------------------------------------
    pose_active = (_diag(h_pp).abs().sum(-1) > 1e-12) & free.poses
    act = pose_active.to(dtype)
    w_scaled = geo.bmm(w_pt, g_ll[plan.pt_pair_point.long()])  # (Np, 6, 3)
    s_sub_pt, z_pt = _slot_gram(
        w_scaled, plan.pt_slot_gather, plan.pt_slot_pose, plan.pt_slot_mask, n_pose
    )
    w_ob_scaled = geo.bmm(w_ob, g_oo[plan.ob_pair_obj.long()])  # (No, 6, 7)
    s_sub_ob, z_ob = _slot_gram(
        w_ob_scaled, plan.ob_slot_gather, plan.ob_slot_pose, plan.ob_slot_mask, n_pose
    )
    # Relpose blocks (diagonal + cross) and the damped pose diagonal, minus
    # its relpose part, as one gram V_rel V_rel^T: column block k of V_rel
    # holds J_b^T at row block before_k and J_a^T at after_k; column block
    # R + p holds the Cholesky factor of pose p's diagonal block.
    diag_blocks = (
        act[:, None, None] * (h_pp_d - h_pp_rel) + (1.0 - act)[:, None, None] * eye6
    )
    l_diag = _cholesky_clamped(diag_blocks)
    n_rel = j_rl_b.shape[0]
    k_rng = torch.arange(n_rel, device=h_pp.device)
    p_rng = torch.arange(n_pose, device=h_pp.device)
    v_rel = _dense_from_pairs(
        torch.cat([rl.before_idx.long(), rl.after_idx.long(), p_rng]),
        torch.cat([k_rng, k_rng, n_rel + p_rng]),
        torch.cat([rl.mask, rl.mask, torch.ones_like(free.poses)]),
        torch.cat([j_rl_b.transpose(1, 2), j_rl_a.transpose(1, 2), l_diag]),
        n_pose,
        n_rel + n_pose,
    )
    s = v_rel @ v_rel.T - s_sub_pt - s_sub_ob

    # ---- reduced RHS: b_S = b_p - sum W H^-1 b = b_p - z (G^T b) ---------
    g_ll_slot = g_ll[plan.pt_slot_land.long()]
    y_pt = (g_ll_slot * b_l[plan.pt_slot_land.long()][:, :, None]).sum(1)
    g_oo_slot = g_oo[plan.ob_slot_land.long()]
    y_ob = (g_oo_slot * b_o[plan.ob_slot_land.long()][:, :, None]).sum(1)
    b_s = b_p - (z_pt.T @ y_pt.reshape(-1) + z_ob.T @ y_ob.reshape(-1)).reshape(n_pose, 6)
    b_s = b_s * act[:, None]

    # ---- Cholesky + one step of iterative refinement ---------------------
    rhs = b_s.reshape(-1)
    chol, info = torch.linalg.cholesky_ex(s)
    delta_raw = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    resid = rhs - s.T @ delta_raw
    delta_ref = delta_raw + torch.cholesky_solve(resid[:, None], chol)[:, 0]
    # A failed factorization zeroes the step: model_cost_change is then 0 and
    # LM rejects it and shrinks the radius (Ceres' linear-solver failure).
    ok = (info == 0) & torch.isfinite(delta_ref).all()
    delta_p = torch.where(ok, delta_ref, torch.zeros_like(delta_ref)).reshape(n_pose, 6)

    # ---- back-substitution: delta_x = H^-1 b_x - G (z^T delta_p) ---------
    def back_substitute(h_inv, b, g_slot, z, slot_mask, slot_land, n_land):
        d = b.shape[-1]
        delta = geo.bmv(h_inv, b)
        corr = geo.bmv(g_slot, (z @ delta_p.reshape(-1)).reshape(-1, d))
        safe = torch.where(slot_mask.any(1), slot_land.long(), n_land)
        padded = torch.cat([delta, delta.new_zeros((1, d))])
        return padded.index_add_(0, safe, -corr)[:n_land]

    delta_l = back_substitute(
        h_ll_inv, b_l, g_ll_slot, z_pt, plan.pt_slot_mask, plan.pt_slot_land, n_point
    )
    delta_l = delta_l * (~ll_singular)[:, None] * point_free[:, None]
    delta_o = back_substitute(
        h_oo_inv, b_o, g_oo_slot, z_ob, plan.ob_slot_mask, plan.ob_slot_land, n_obj
    )
    delta_o = delta_o * (~oo_singular)[:, None] * obj_free[:, None]
    delta_p = delta_p * act[:, None]

    # ---- model cost change: 0.5 (delta'b + delta' D delta) ---------------
    # The damped system H_d delta = b holds, and H_d = H_u + D with
    # D = diag(clamp(diag(H_u))) / radius, so -m'(r + m/2) reduces to this.
    quad_damp = (
        (clip_diag(h_pp) * delta_p * delta_p).sum()
        + (clip_diag(h_ll) * delta_l * delta_l).sum()
        + (clip_diag(h_oo) * delta_o * delta_o).sum()
    )
    model_cost_change = 0.5 * (
        (delta_p * b_p).sum() + (delta_l * b_l).sum() + (delta_o * b_o).sum()
        + inv_radius * quad_damp
    )
    return BAState(delta_p, delta_l, delta_o), model_cost_change, grad_max
