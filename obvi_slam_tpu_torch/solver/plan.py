"""Host-side sparsity plan of the Schur-complement step (numpy only).

Counterpart of the plan half of ``obvi_slam_tpu/solver/schur.py``
(``SchurPlan``, ``_round_up``, ``_slot_layout``, the numpy ``_build_pairs``,
``_band_layout``, ``_rel_band_layout``, ``_pair_factor_gather``,
``build_schur_plan``, ``build_schur_plan_host``).
The pair plan's core runs in the native runtime (``native``, the
reference's C++ copied), or in its numpy twin ``_pair_plan_numpy`` with
``native=False``; the two give the same arrays.

From ``3 * BAND_TP`` = 192 poses up, ``_band_layout`` regroups the point
slot grid into 64-pose groups for the banded gram (kernel K3), and
``_rel_band_layout`` builds the matching relpose layout when the relpose
chain is given, as the reference's ``_band_layout`` and ``_rel_band_layout``
do. Wide spans (loop closures) fall back to the dense layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from obvi_slam_tpu_torch import native as native_mod

# Poses per band group; each group's local pose window is 2 * BAND_TP wide,
# and banding starts at 3 groups' worth of poses.
BAND_TP = 64


class SchurPlan(NamedTuple):
    """Precomputed gather/scatter indices; all arrays padded, masks mark
    live rows. "Pairs" are unique (pose, landmark) combinations; "cross" rows
    are ordered pair-row pairs sharing a landmark; the slot grid lists each
    observed landmark's pair rows."""

    rp_factor_pair: object  # (F,) factor row -> point-pair row
    pt_pair_pose: object  # (Np,)
    pt_pair_point: object  # (Np,)
    pt_pair_mask: object  # (Np,)
    pt_cross_a: object  # (Ncp,)
    pt_cross_b: object  # (Ncp,)
    pt_cross_mask: object  # (Ncp,)
    pt_cross_dest: object  # (Ncp,)
    pt_dest_a: object  # (Nd,)
    pt_dest_b: object  # (Nd,)
    pt_dest_mask: object  # (Nd,)
    pt_slot_gather: object  # (Lp, Cp) -> point-pair row
    pt_slot_pose: object  # (Lp, Cp)
    pt_slot_mask: object  # (Lp, Cp)
    pt_slot_land: object  # (Lp,)
    bb_factor_pair: object  # (B,)
    ob_pair_pose: object  # (No,)
    ob_pair_obj: object  # (No,)
    ob_pair_mask: object  # (No,)
    ob_cross_a: object  # (Nco,)
    ob_cross_b: object  # (Nco,)
    ob_cross_mask: object  # (Nco,)
    ob_cross_dest: object  # (Nco,)
    ob_dest_a: object  # (Ndo,)
    ob_dest_b: object  # (Ndo,)
    ob_dest_mask: object  # (Ndo,)
    ob_slot_gather: object  # (Lo, Co)
    ob_slot_pose: object  # (Lo, Co)
    ob_slot_mask: object  # (Lo, Co)
    ob_slot_land: object  # (Lo,)
    # Banded point gram: when set, the pt_slot_* rows above are reordered by
    # 64-pose home group into G groups of Lg rows, and this (G, Lg, Cp)
    # array holds each slot's pose relative to its group's first pose.
    pt_band_local_pose: object = None
    # Banded relpose layout (rows: relpose factors with 2 slots, then one
    # single-slot row per pose); None when some relpose pair is too wide.
    rel_band_gather: object = None  # (L2, 2)
    rel_band_mask: object = None  # (L2, 2)
    rel_band_local_pose: object = None  # (G, Lg2, 2)
    # Factor row per pair row when factor -> pair is injective, else None.
    pt_pair_factor: object = None
    ob_pair_factor: object = None


def _round_up(n, bucket=64):
    """Next capacity from the {2^k, 1.5*2^k} grid (>= bucket)."""
    n = max(int(n), bucket)
    p = 1 << (n - 1).bit_length()
    mid = p // 2 + p // 4
    return mid if n <= mid else p


def _slot_layout(pair_block, pair_land, n_pairs, land_cap=None, cmax_cap=None):
    """Regroup pair rows by landmark into a (land, slot) grid: returns
    (slot_gather, slot_pose, slot_mask) of shape (L, C) and slot_land (L,).
    Dead slots carry gather = pose = 0 and mask False."""
    pair_block = np.asarray(pair_block)[:n_pairs]
    pair_land = np.asarray(pair_land)[:n_pairs]
    if n_pairs:
        uniq_land, inv = np.unique(pair_land, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(uniq_land))
        c_max = int(counts.max())
        starts = np.zeros(len(uniq_land), dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        rows = inv[order]
        slot = np.arange(n_pairs, dtype=np.int64) - starts[rows]
        n_land = len(uniq_land)
    else:
        order = rows = slot = np.zeros(0, dtype=np.int64)
        c_max = 0
        n_land = 0
    land_cap = max(land_cap or 0, _round_up(n_land))
    cmax_cap = max(cmax_cap or 0, _round_up(c_max, bucket=4))
    gather = np.zeros((land_cap, cmax_cap), dtype=np.int32)
    pose = np.zeros((land_cap, cmax_cap), dtype=np.int32)
    mask = np.zeros((land_cap, cmax_cap), dtype=bool)
    land = np.zeros(land_cap, dtype=np.int32)
    gather[rows, slot] = order.astype(np.int32)
    pose[rows, slot] = pair_block[order].astype(np.int32)
    mask[rows, slot] = True
    land[:n_land] = uniq_land.astype(np.int32) if n_land else land[:0]
    return gather, pose, mask, land


def _band_layout(slot_gather, slot_pose, slot_mask, slot_land, n_pose, lg_cap=None):
    """Regroup slot-grid rows by 64-pose home group for the banded gram.

    Returns None when banding does not apply (fewer than 3 * BAND_TP poses,
    no live row, or a live landmark whose poses span past its 128-pose
    window); otherwise (gather, pose, mask, land, local_pose): the slot grid
    with group g's rows at [g * Lg, g * Lg + count_g), and the (G, Lg, C)
    pose of each slot relative to its group's first pose (0 when dead)."""
    if n_pose is None or n_pose < 3 * BAND_TP:
        return None
    slot_pose = np.asarray(slot_pose)
    slot_mask = np.asarray(slot_mask)
    live_row = slot_mask.any(axis=1)
    if not live_row.any():
        return None
    min_p = np.where(slot_mask, slot_pose, np.iinfo(np.int32).max).min(axis=1)
    max_p = np.where(slot_mask, slot_pose, -1).max(axis=1)
    n_group = -(-int(n_pose) // BAND_TP)
    home = np.clip(
        np.where(live_row, min_p // BAND_TP, 0), 0, n_group - 1
    ).astype(np.int64)
    if np.any(live_row & (max_p - home * BAND_TP >= 2 * BAND_TP)):
        return None
    counts = np.bincount(home[live_row], minlength=n_group)
    # Lg in 128-row steps (a pinned lg_cap is a minimum).
    lg = max(lg_cap or 0, -(-int(counts.max()) // 128) * 128)
    _, n_slot = slot_mask.shape
    rows = np.nonzero(live_row)[0]
    order = rows[np.argsort(home[rows], kind="stable")]
    within = np.arange(len(order)) - np.concatenate(([0], np.cumsum(counts)[:-1]))[home[order]]
    dest = home[order] * lg + within
    gather = np.zeros((n_group * lg, n_slot), dtype=np.int32)
    pose = np.zeros((n_group * lg, n_slot), dtype=np.int32)
    mask = np.zeros((n_group * lg, n_slot), dtype=bool)
    land = np.zeros(n_group * lg, dtype=np.int32)
    local = np.zeros((n_group * lg, n_slot), dtype=np.int32)
    gather[dest] = np.asarray(slot_gather)[order]
    pose[dest] = slot_pose[order]
    mask[dest] = slot_mask[order]
    land[dest] = np.asarray(slot_land)[order]
    local[dest] = np.where(
        slot_mask[order], slot_pose[order] - (home[order] * BAND_TP)[:, None], 0
    )
    return gather, pose, mask, land, local.reshape(n_group, lg, n_slot)


def _rel_band_layout(rl_before, rl_after, rl_cap, n_pose, lg_cap=None):
    """Band layout of the relpose + pose-diagonal rows: rl_cap relpose rows
    (slot 0 gathers J_b^T at k, slot 1 J_a^T at rl_cap + k) and one
    single-slot row per pose (gathering 2 rl_cap + p). Returns
    (gather, mask, local_pose) or None when banding does not apply."""
    if n_pose is None or n_pose < 3 * BAND_TP:
        return None
    rl_before = np.asarray(rl_before, dtype=np.int64)
    rl_after = np.asarray(rl_after, dtype=np.int64)
    n_live = len(rl_before)
    n_rows = rl_cap + n_pose
    gather = np.zeros((n_rows, 2), np.int32)
    pose = np.zeros((n_rows, 2), np.int32)
    mask = np.zeros((n_rows, 2), bool)
    gather[:rl_cap, 0] = np.arange(rl_cap)
    gather[:rl_cap, 1] = rl_cap + np.arange(rl_cap)
    pose[:n_live, 0] = rl_before
    pose[:n_live, 1] = rl_after
    mask[:n_live, :] = True
    gather[rl_cap:, 0] = 2 * rl_cap + np.arange(n_pose)
    pose[rl_cap:, 0] = np.arange(n_pose)
    mask[rl_cap:, 0] = True
    out = _band_layout(gather, pose, mask, np.zeros(n_rows, np.int32), n_pose, lg_cap)
    if out is None:
        return None
    g2, _, m2, _, local = out
    return g2, m2, local


def _pad_i(x, cap, fill=0):
    out = np.full(cap, fill, dtype=np.int32)
    out[: len(x)] = x
    return out


def _unique_rows(a, b):
    """``np.unique(np.stack([a, b], 1), axis=0, return_inverse=True)`` for
    non-negative integer columns, through one int64 key per row (the same
    lexicographic order; a 1-D sort instead of a sort of row records)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    span = int(b.max()) + 1 if len(b) else 1
    keys, inv = np.unique(a * span + b, return_inverse=True)
    return np.stack([keys // span, keys % span], axis=1), inv.reshape(-1)


def _pair_plan_numpy(block_idx, land_idx, mask):
    """The numpy twin of ``native.build_pair_plan``: (factor_pair,
    pair_block, pair_land, cross_a, cross_b, cross_dest, dest_a, dest_b),
    unpadded."""
    live = np.nonzero(mask)[0]
    uniq, inv = _unique_rows(block_idx[live], land_idx[live])
    n_pairs = len(uniq)
    factor_pair = np.zeros(len(block_idx), dtype=np.int32)
    factor_pair[live] = inv.astype(np.int32)

    cross_a, cross_b = [], []
    if n_pairs:
        order = np.argsort(uniq[:, 1], kind="stable")
        sorted_land = uniq[order, 1]
        boundaries = np.nonzero(np.diff(sorted_land))[0] + 1
        for g in np.split(order, boundaries):
            a, b = np.meshgrid(g, g, indexing="ij")
            cross_a.append(a.ravel())
            cross_b.append(b.ravel())
    cross_a = np.concatenate(cross_a) if cross_a else np.zeros(0, dtype=np.int64)
    cross_b = np.concatenate(cross_b) if cross_b else np.zeros(0, dtype=np.int64)

    # Group cross rows by destination (pose_a, pose_b) block of S.
    if n_pairs and len(cross_a):
        dest_uniq, dest_inv = _unique_rows(uniq[cross_a, 0], uniq[cross_b, 0])
        order = np.argsort(dest_inv, kind="stable")
        cross_a = cross_a[order]
        cross_b = cross_b[order]
        cross_dest = dest_inv[order]
    else:
        dest_uniq = np.zeros((0, 2), dtype=np.int64)
        cross_dest = np.zeros(0, dtype=np.int64)
    return (factor_pair, uniq[:, 0], uniq[:, 1], cross_a, cross_b, cross_dest,
            dest_uniq[:, 0], dest_uniq[:, 1])


def _build_pairs(
    block_idx, land_idx, mask, pair_cap=None, cross_cap=None,
    land_cap=None, cmax_cap=None, dest_cap=None, native=True,
):
    """Unique (pose, landmark) pairs, the per-landmark ordered cross pairs
    grouped by destination block, and the slot grid, padded to the caps.
    The core comes from the native runtime, or from its numpy twin with
    ``native=False``; the two are equal array for array."""
    core = (native_mod.build_pair_plan if native else _pair_plan_numpy)(
        block_idx, land_idx, mask)
    factor_pair, pair_block, pair_land, cross_a, cross_b, cross_dest, dest_a, dest_b = core
    n_pairs = len(pair_block)
    n_dest = len(dest_a)

    pair_cap = max(pair_cap or 0, _round_up(n_pairs))
    cross_cap = max(cross_cap or 0, _round_up(len(cross_a)))
    dest_cap = max(dest_cap or 0, _round_up(n_dest))
    pair_mask = np.zeros(pair_cap, dtype=bool)
    pair_mask[:n_pairs] = True
    cross_mask = np.zeros(cross_cap, dtype=bool)
    cross_mask[: len(cross_a)] = True
    dest_mask = np.zeros(dest_cap, dtype=bool)
    dest_mask[:n_dest] = True
    # Padding cross rows point at a padding destination.
    cross_dest_padded = _pad_i(cross_dest, cross_cap, fill=min(n_dest, dest_cap - 1))
    return (
        factor_pair,
        _pad_i(pair_block, pair_cap),
        _pad_i(pair_land, pair_cap),
        pair_mask,
        _pad_i(cross_a, cross_cap),
        _pad_i(cross_b, cross_cap),
        cross_mask,
        cross_dest_padded,
        _pad_i(dest_a, dest_cap),
        _pad_i(dest_b, dest_cap),
        dest_mask,
    ) + _slot_layout(pair_block, pair_land, n_pairs, land_cap, cmax_cap)


def _pair_factor_gather(factor_pair, factor_mask, pair_cap):
    """Factor row per pair row when factor -> pair is injective (0 for
    padding), or None when a pair has 2+ factors."""
    live = np.nonzero(np.asarray(factor_mask))[0]
    fp = np.asarray(factor_pair)[live]
    if len(fp) and len(np.unique(fp)) != len(fp):
        return None
    out = np.zeros(pair_cap, dtype=np.int32)
    out[fp] = live.astype(np.int32)
    return out


def _to_device(plan: SchurPlan, device) -> SchurPlan:
    return SchurPlan(*(
        None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for x in plan
    ))


def build_schur_plan_numpy(
    rp_pose, rp_point, rp_mask, bb_pose, bb_obj, bb_mask, caps=None, n_pose=None,
    rl_before=None, rl_after=None, rl_cap=0, native=True,
) -> SchurPlan:
    """The plan as numpy arrays from padded index columns and masks.

    ``caps`` pins minimum capacities (keys pt_pair, pt_cross, pt_slot_land,
    pt_slot_c, pt_dest, the ob_* twins, pt_band_lg, rel_band_lg).
    ``rl_before``/``rl_after`` are the live relpose pairs and ``rl_cap`` the
    relpose table capacity; without them no relpose band is built.
    ``native=False`` builds the pairs with the numpy twin."""
    caps = caps or {}
    pt = _build_pairs(
        np.asarray(rp_pose), np.asarray(rp_point), np.asarray(rp_mask),
        caps.get("pt_pair"), caps.get("pt_cross"), caps.get("pt_slot_land"),
        caps.get("pt_slot_c"), caps.get("pt_dest"), native,
    )
    ob = _build_pairs(
        np.asarray(bb_pose), np.asarray(bb_obj), np.asarray(bb_mask),
        caps.get("ob_pair"), caps.get("ob_cross"), caps.get("ob_slot_land"),
        caps.get("ob_slot_c"), caps.get("ob_dest"), native,
    )
    pt_slot = pt[11:]
    band = _band_layout(*pt_slot, n_pose, caps.get("pt_band_lg"))
    pt_band_local_pose = None
    if band is not None:
        pt_slot, pt_band_local_pose = band[:4], band[4]
    rel_band = None
    if rl_before is not None and rl_cap:
        rel_band = _rel_band_layout(
            rl_before, rl_after, int(rl_cap), n_pose, caps.get("rel_band_lg")
        )
    return SchurPlan(
        *pt[:11],
        *pt_slot,
        *ob,
        pt_band_local_pose=pt_band_local_pose,
        rel_band_gather=None if rel_band is None else rel_band[0],
        rel_band_mask=None if rel_band is None else rel_band[1],
        rel_band_local_pose=None if rel_band is None else rel_band[2],
        pt_pair_factor=_pair_factor_gather(pt[0], rp_mask, len(pt[1])),
        ob_pair_factor=_pair_factor_gather(ob[0], bb_mask, len(ob[1])),
    )


def build_schur_plan(
    tables, caps=None, n_pose=None, rl_before=None, rl_after=None, rl_cap=0,
    device="cuda", native=True,
) -> SchurPlan:
    """Plan from the factor tables' index columns (read back to the host)."""
    rp, bb = tables.reproj, tables.bbox

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    plan = build_schur_plan_numpy(
        host(rp.pose_idx), host(rp.point_idx), host(rp.mask),
        host(bb.pose_idx), host(bb.obj_idx), host(bb.mask), caps, n_pose,
        rl_before, rl_after, rl_cap, native,
    )
    return _to_device(plan, device)


def build_schur_plan_host(
    rp_pose, rp_point, rp_cap, bb_pose, bb_obj, bb_cap, caps=None,
    n_pose=None, rl_before=None, rl_after=None, rl_cap=0, device="cuda", native=True,
) -> SchurPlan:
    """Plan from live host index lists; ``*_cap`` are the table capacities."""

    def padded(vals, cap):
        out = np.zeros(cap, dtype=np.int32)
        out[: len(vals)] = np.asarray(vals, dtype=np.int32)
        mask = np.zeros(cap, dtype=bool)
        mask[: len(vals)] = True
        return out, mask

    rp_pose_a, rp_mask = padded(rp_pose, rp_cap)
    rp_point_a, _ = padded(rp_point, rp_cap)
    bb_pose_a, bb_mask = padded(bb_pose, bb_cap)
    bb_obj_a, _ = padded(bb_obj, bb_cap)
    plan = build_schur_plan_numpy(
        rp_pose_a, rp_point_a, rp_mask, bb_pose_a, bb_obj_a, bb_mask, caps, n_pose,
        rl_before, rl_after, rl_cap, native,
    )
    return _to_device(plan, device)
