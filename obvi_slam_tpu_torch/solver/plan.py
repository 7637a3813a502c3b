"""Host-side sparsity plan of the Schur-complement step (numpy only).

Counterpart of the plan half of ``obvi_slam_tpu/solver/schur.py``
(``SchurPlan``, ``_round_up``, ``_slot_layout``, the numpy ``_build_pairs``,
``_pair_factor_gather``, ``build_schur_plan``, ``build_schur_plan_host``).
The reference's native C++ pair builder is not copied: its numpy twin here
is the specification and gives the same arrays.

The banded layouts engage at >= 192 poses in the reference; this port does
not build them yet, so a plan for that many poses raises
``NotImplementedError`` instead of silently taking the dense layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Poses per band tile in the reference; banding starts at 3 tiles.
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
    # Band layouts: always None in this port (see module docstring).
    pt_band_local_pose: object = None
    rel_band_gather: object = None
    rel_band_mask: object = None
    rel_band_local_pose: object = None
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


def _pad_i(x, cap, fill=0):
    out = np.full(cap, fill, dtype=np.int32)
    out[: len(x)] = x
    return out


def _build_pairs(
    block_idx, land_idx, mask, pair_cap=None, cross_cap=None,
    land_cap=None, cmax_cap=None, dest_cap=None,
):
    """Unique (pose, landmark) pairs, the per-landmark ordered cross pairs
    grouped by destination block, and the slot grid."""
    live = np.nonzero(mask)[0]
    keys = np.stack([block_idx[live], land_idx[live]], axis=1)
    if len(live) == 0:
        uniq = np.zeros((0, 2), dtype=np.int64)
        inv = np.zeros((0,), dtype=np.int64)
    else:
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
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
        dest_keys = np.stack(
            [uniq[cross_a, 0].astype(np.int64), uniq[cross_b, 0].astype(np.int64)],
            axis=1,
        )
        dest_uniq, dest_inv = np.unique(dest_keys, axis=0, return_inverse=True)
        dest_inv = dest_inv.reshape(-1)
        order = np.argsort(dest_inv, kind="stable")
        cross_a = cross_a[order]
        cross_b = cross_b[order]
        cross_dest = dest_inv[order]
    else:
        dest_uniq = np.zeros((0, 2), dtype=np.int64)
        cross_dest = np.zeros(0, dtype=np.int64)
    n_dest = len(dest_uniq)

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
    pair_block = uniq[:, 0] if n_pairs else np.zeros(0, np.int64)
    pair_land = uniq[:, 1] if n_pairs else np.zeros(0, np.int64)
    return (
        factor_pair,
        _pad_i(pair_block, pair_cap),
        _pad_i(pair_land, pair_cap),
        pair_mask,
        _pad_i(cross_a, cross_cap),
        _pad_i(cross_b, cross_cap),
        cross_mask,
        cross_dest_padded,
        _pad_i(dest_uniq[:, 0] if n_dest else [], dest_cap),
        _pad_i(dest_uniq[:, 1] if n_dest else [], dest_cap),
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
) -> SchurPlan:
    """The plan as numpy arrays from padded index columns and masks."""
    if n_pose is not None and n_pose >= 3 * BAND_TP:
        raise NotImplementedError(
            f"{n_pose} poses: the banded Schur layout (>= {3 * BAND_TP} poses) "
            "is not ported yet"
        )
    caps = caps or {}
    pt = _build_pairs(
        np.asarray(rp_pose), np.asarray(rp_point), np.asarray(rp_mask),
        caps.get("pt_pair"), caps.get("pt_cross"), caps.get("pt_slot_land"),
        caps.get("pt_slot_c"), caps.get("pt_dest"),
    )
    ob = _build_pairs(
        np.asarray(bb_pose), np.asarray(bb_obj), np.asarray(bb_mask),
        caps.get("ob_pair"), caps.get("ob_cross"), caps.get("ob_slot_land"),
        caps.get("ob_slot_c"), caps.get("ob_dest"),
    )
    return SchurPlan(
        *pt,
        *ob,
        pt_pair_factor=_pair_factor_gather(pt[0], rp_mask, len(pt[1])),
        ob_pair_factor=_pair_factor_gather(ob[0], bb_mask, len(ob[1])),
    )


def build_schur_plan(tables, caps=None, n_pose=None, device="cuda") -> SchurPlan:
    """Plan from the factor tables' index columns (read back to the host)."""
    rp, bb = tables.reproj, tables.bbox

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    plan = build_schur_plan_numpy(
        host(rp.pose_idx), host(rp.point_idx), host(rp.mask),
        host(bb.pose_idx), host(bb.obj_idx), host(bb.mask), caps, n_pose,
    )
    return _to_device(plan, device)


def build_schur_plan_host(
    rp_pose, rp_point, rp_cap, bb_pose, bb_obj, bb_cap, caps=None,
    n_pose=None, device="cuda",
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
        rp_pose_a, rp_point_a, rp_mask, bb_pose_a, bb_obj_a, bb_mask, caps, n_pose
    )
    return _to_device(plan, device)
