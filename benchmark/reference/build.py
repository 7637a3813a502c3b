"""Plain problems of the reference from numpy arrays.

``plain_problem`` takes a flat dict of arrays named by family and column
(``reproj_pose``, ``reproj_point``, ``reproj_cam``, ``reproj_obs``,
``reproj_mult``; ``bbox_obj``, ``bbox_pose``, ``bbox_cam``,
``bbox_corners``, ``bbox_sqrt_inf``; ``shape_obj``, ``shape_mean``,
``shape_sqrt_inf``; ``relpose_before``, ``relpose_after``, ``relpose_t``,
``relpose_r``, ``relpose_sqrt_inf``; ``ltm_obj``, ``ltm_mean``,
``ltm_sqrt_inf``; ``prior_kind``, ``prior_block``, ``prior_param``,
``prior_mean``, ``prior_inv_std``), each family with optional ``_mask`` (rows
that exist) and ``_w`` (their weights, 1 where absent), the state
(``poses``, ``points``, ``objects``), ``free_*`` (all free where absent) and
the cameras (``cam_r``, ``cam_t``: robot to camera; one camera at the
robot's origin where absent). Absent families are empty.

Rows that do not exist (``_mask`` False) are dropped, and so are the state's
rows that no remaining row reads (a program's tables are padded to fixed
capacities): ``PlainProblem.keep`` maps the problem's poses, objects and
points back to the arrays' rows, and ``take`` cuts a full state down.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.factors import PlainProblem

COLUMNS = {
    "reproj": (("pose", "i"), ("point", "i"), ("cam", "i"), ("obs", 2), ("mult", 2)),
    "bbox": (("obj", "i"), ("pose", "i"), ("cam", "i"), ("corners", 4), ("sqrt_inf", (4, 4))),
    "shape": (("obj", "i"), ("mean", 3), ("sqrt_inf", (3, 3))),
    "relpose": (("before", "i"), ("after", "i"), ("t", 3), ("r", (3, 3)),
                ("sqrt_inf", (6, 6))),
    "ltm": (("obj", "i"), ("mean", 7), ("sqrt_inf", (7, 7))),
    "prior": (("kind", "i"), ("block", "i"), ("param", "i"), ("mean", ()), ("inv_std", ())),
}
# Column names inside PlainProblem where they differ from the arrays'.
RENAME = {("relpose", "t"): "meas_t", ("relpose", "r"): "meas_r"}


# Index columns of each family and the state table each reads.
READS = {"reproj": (("pose", "poses"), ("point", "points")),
         "bbox": (("obj", "objects"), ("pose", "poses")),
         "shape": (("obj", "objects"),), "relpose": (("before", "poses"), ("after", "poses")),
         "ltm": (("obj", "objects"),)}
PRIOR_KINDS = ("poses", "points", "objects")


def compact(arrays: dict):
    """(arrays with only existing rows and the state rows they read,
    {state table: kept row indices})."""
    a = dict(arrays)
    for fam, cols in COLUMNS.items():
        key = f"{fam}_mask"
        if key not in a or f"{fam}_{cols[0][0]}" not in a:
            continue
        live = np.asarray(a.pop(key), bool)
        for suffix in [c for c, _ in cols] + ["w"]:
            if f"{fam}_{suffix}" in a:
                a[f"{fam}_{suffix}"] = np.asarray(a[f"{fam}_{suffix}"])[live]
    used = {t: [] for t in PRIOR_KINDS}
    for fam, cols in READS.items():
        for col, table in cols:
            if f"{fam}_{col}" in a:
                used[table].append(np.asarray(a[f"{fam}_{col}"]))
    if "prior_kind" in a:
        for k, table in enumerate(PRIOR_KINDS):
            used[table].append(np.asarray(a["prior_block"])[np.asarray(a["prior_kind"]) == k])
    keep = {t: np.unique(np.concatenate(v)).astype(np.int64) if v else np.zeros(0, np.int64)
            for t, v in used.items()}
    for fam, cols in READS.items():
        for col, table in cols:
            if f"{fam}_{col}" in a:
                a[f"{fam}_{col}"] = np.searchsorted(keep[table], a[f"{fam}_{col}"])
    if "prior_kind" in a:
        block = np.asarray(a["prior_block"]).copy()
        for k, table in enumerate(PRIOR_KINDS):
            sel = np.asarray(a["prior_kind"]) == k
            block[sel] = np.searchsorted(keep[table], block[sel])
        a["prior_block"] = block
    for table, dim in (("poses", 6), ("points", 3), ("objects", 7)):
        a[table] = np.reshape(a[table], (-1, dim))[keep[table]]
        if f"free_{table}" in a:
            a[f"free_{table}"] = np.asarray(a[f"free_{table}"])[keep[table]]
    return a, keep


def plain_problem(arrays: dict, huber: dict, dtype=torch.float64, device="cpu") -> PlainProblem:
    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.long, device=device)

    def b(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.bool, device=device)

    arrays, keep = compact(arrays)
    factors = {}
    for fam, cols in COLUMNS.items():
        first = f"{fam}_{cols[0][0]}"
        n = len(arrays[first]) if first in arrays else 0
        rows = {}
        for name, shape in cols:
            key = RENAME.get((fam, name), name)
            if f"{fam}_{name}" in arrays:
                val = np.asarray(arrays[f"{fam}_{name}"])
            elif name == "cam":
                val = np.zeros(n, np.int64)
            else:
                dims = () if shape == "i" else ((shape,) if isinstance(shape, int) else shape)
                val = np.zeros((n,) + tuple(dims))
            rows[key] = i(val) if shape == "i" else f(np.reshape(val, (n,) + np.shape(val)[1:]))
        mask = np.asarray(arrays.get(f"{fam}_mask", np.ones(n, bool)), bool)
        w = np.asarray(arrays.get(f"{fam}_w", np.ones(n)), np.float64) * mask
        rows["mask"], rows["w"] = b(mask), f(w)
        factors[fam] = rows
    poses, points, objects = (np.reshape(arrays[k], (-1, d)) for k, d in
                              (("poses", 6), ("points", 3), ("objects", 7)))
    cam_r = arrays.get("cam_r", np.eye(3)[None])
    cam_t = arrays.get("cam_t", np.zeros((1, 3)))
    return PlainProblem(
        poses=f(poses), points=f(points), objects=f(objects),
        free_poses=b(arrays.get("free_poses", np.ones(len(poses), bool))),
        free_points=b(arrays.get("free_points", np.ones(len(points), bool))),
        free_objects=b(arrays.get("free_objects", np.ones(len(objects), bool))),
        cam_r=f(cam_r), cam_t=f(cam_t), factors=factors, huber=dict(huber), keep=keep,
    )
