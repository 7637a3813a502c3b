"""Jacobian debug extraction: the debug-oracle subsystem
(``jacobian_extraction.cpp``: sparse Jacobian dumps with per-column factor
attribution, zero-column validation, Hessian-diagonal inspection), the
port's counterpart of ``obvi_slam_tpu/solver/jacobian_debug.py``.

The block Jacobians come from the factor families (reprojection and
bounding box through the kernel wrappers ``ops.reproj_residuals_and_jac``
and ``ops.bbox_residuals_and_jac``: K1 and K2 on the card, their plain
versions on the CPU) and are assembled, with array operations, into sparse
COO triplets in the reference's order (family by family, live factor rows
in table order, each factor's blocks in turn, row-major) with a
column -> block attribution map.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import ops


@dataclass
class JacobianInfo:
    """Sparse Jacobian (COO) + attribution."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    n_rows: int
    n_cols: int
    # column -> (block_kind, block_row, param_idx); kinds: pose/point/object
    col_owner: List[Tuple[str, int, int]] = field(default_factory=list)
    # row -> (factor_family, factor_row)
    row_owner: List[Tuple[str, int]] = field(default_factory=list)


def _host(x):
    return x.detach().cpu().numpy()


def extract_jacobian(state, cams, tables, huber=None) -> JacobianInfo:
    """Assemble the full (unweighted-by-loss) Jacobian in COO form."""
    n_pose = state.poses.shape[0]
    n_point = state.points.shape[0]
    n_obj = state.objects.shape[0]
    point_off = n_pose * 6
    obj_off = point_off + n_point * 3
    n_cols = obj_off + n_obj * 7
    col_owner = (
        [("pose", i, k) for i in range(n_pose) for k in range(6)]
        + [("point", i, k) for i in range(n_point) for k in range(3)]
        + [("object", i, k) for i in range(n_obj) for k in range(7)]
    )
    invalid = 1e6 if huber is None else huber.invalid_ellipse_error
    rp, bb, sh, rl, lt = tables.reproj, tables.bbox, tables.shape, tables.relpose, tables.ltm
    _, j_rp_pose, j_rp_point = ops.reproj_residuals_and_jac(state, cams, rp)
    _, j_bb_obj, j_bb_pose = ops.bbox_residuals_and_jac(state, cams, bb, invalid)
    _, j_sh = fac.shape_residuals_and_jac(state, sh)
    _, j_rl_b, j_rl_a = fac.relpose_residuals_and_jac(state, rl)
    _, j_lt = fac.ltm_residuals_and_jac(state, lt)
    # (family, mask, [(block Jacobians, block index, column offset, width)]).
    families = (
        ("reprojection", rp.mask, [(j_rp_pose, rp.pose_idx, 0, 6),
                                   (j_rp_point, rp.point_idx, point_off, 3)]),
        ("bounding_box", bb.mask, [(j_bb_obj, bb.obj_idx, obj_off, 7),
                                   (j_bb_pose, bb.pose_idx, 0, 6)]),
        ("shape_prior", sh.mask, [(j_sh, sh.obj_idx, obj_off, 7)]),
        ("relative_pose", rl.mask, [(j_rl_b, rl.before_idx, 0, 6),
                                    (j_rl_a, rl.after_idx, 0, 6)]),
        ("ltm_prior", lt.mask, [(j_lt, lt.obj_idx, obj_off, 7)]),
    )
    rows, cols, vals, row_owner = [], [], [], []
    row = 0
    for name, mask, blocks in families:
        live = np.nonzero(_host(mask))[0]
        r_dim = blocks[0][0].shape[1]
        base = row + r_dim * np.arange(len(live), dtype=np.int64)
        fam_rows, fam_cols, fam_vals = [], [], []
        for j, idx, off, width in blocks:
            col0 = off + width * _host(idx)[live].astype(np.int64)
            shape, flat = (len(live), r_dim, width), (len(live), r_dim * width)
            rr = base[:, None, None] + np.arange(r_dim)[None, :, None]
            cc = col0[:, None, None] + np.arange(width)[None, None, :]
            fam_rows.append(np.broadcast_to(rr, shape).reshape(flat))
            fam_cols.append(np.broadcast_to(cc, shape).reshape(flat))
            fam_vals.append(_host(j[torch.as_tensor(live, device=j.device)]).reshape(flat))
        rows.append(np.concatenate(fam_rows, 1).ravel())
        cols.append(np.concatenate(fam_cols, 1).ravel())
        vals.append(np.concatenate(fam_vals, 1).ravel())
        row_owner += [(name, int(k)) for k in live]
        row += r_dim * len(live)
    return JacobianInfo(
        rows=np.concatenate(rows), cols=np.concatenate(cols), vals=np.concatenate(vals),
        n_rows=row, n_cols=n_cols, col_owner=col_owner, row_owner=row_owner,
    )


def column_norms(info: JacobianInfo) -> np.ndarray:
    norms_sq = np.zeros(info.n_cols)
    np.add.at(norms_sq, info.cols, info.vals**2)
    return np.sqrt(norms_sq)


def validate_zero_columns(info: JacobianInfo, free_cols=None, tol=1e-12):
    """validateZeroColumnEntries (jacobian_extraction.cpp:419): columns of
    free parameters with (near-)zero norm indicate unconstrained parameters.
    Returns a list of (block_kind, block_row, param_idx, norm)."""
    norms = column_norms(info)
    bad = norms < tol
    if free_cols is not None:
        bad &= np.asarray(free_cols, dtype=bool)
    return [(*info.col_owner[c], float(norms[c])) for c in np.nonzero(bad)[0]]


def hessian_diagonal(info: JacobianInfo) -> np.ndarray:
    """Diagonal of J^T J (debug_jacobian_hessian_diagonal equivalent)."""
    return column_norms(info) ** 2


def write_jacobian_csv(info: JacobianInfo, path: str):
    """Sparse triplets and, beside them (``*_columns.csv``), the per-column
    attribution (writeJacobianToFile analog)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("row,col,value\n")
        for r, c, v in zip(info.rows, info.cols, info.vals):
            f.write(f"{r},{c},{v}\n")
    attr_path = path.replace(".csv", "_columns.csv")
    with open(attr_path, "w") as f:
        f.write("col,block_kind,block_row,param_idx,col_norm\n")
        norms = column_norms(info)
        for c, (kind, row, param) in enumerate(info.col_owner):
            f.write(f"{c},{kind},{row},{param},{norms[c]}\n")
