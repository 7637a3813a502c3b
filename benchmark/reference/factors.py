"""Plain PyTorch factor graph of the reference: the cost of a bundle
adjustment problem and its Gauss-Newton linearization.

A problem is a ``PlainProblem``: the initial state (poses [t, axis-angle],
points, yaw-only ellipsoids [x, y, z, yaw, dx, dy, dz]), which blocks are
free, the cameras and six factor families, each a dict of row tensors with
a weight ``w`` per row (0 drops the row):

    reproj    pose, point, cam, obs (rectified), mult: mult * (proj - obs)
    bbox      obj, pose, cam, corners, sqrt_inf: sqrt_inf @ (box - corners),
              every entry ``invalid`` where the projection degenerates
    shape     obj, mean, sqrt_inf: sqrt_inf @ (dims - mean)
    relpose   before, after, meas_t, meas_r, sqrt_inf: sqrt_inf @
              [R_b^T (t_a - t_b) - meas_t, log(R_b^T R_a meas_r^T)]
    ltm       obj, mean, sqrt_inf: sqrt_inf @ (object - mean)
    prior     kind (0 pose, 1 point, 2 object), block, param, mean,
              inv_std: inv_std * (x - mean), no robust loss

The cost is 0.5 * sum_rows w * rho(|r|^2), rho Huber with the family's
scale (Ceres' HuberLoss), plus 0.5 * sum w * r^2 of the priors. Jacobians
come from ``torch.func.jacfwd`` of the row functions. Nothing here imports
the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from benchmark.reference import geometry as geo

ROBUST = ("reproj", "bbox", "shape", "relpose", "ltm")

# Applied to the operands of the products that form the Gauss-Newton system
# and its Schur complement (``rounded``): None leaves them as they are. A
# control in the program's place (``benchmark/control.py``) sets ``tf32``
# and computes in float32.
operand_rounding = None


def tf32(x):
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits, as a
    TF32 matrix product reads its operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def rounded(x):
    return x if operand_rounding is None else operand_rounding(x)


@dataclass
class PlainProblem:
    poses: torch.Tensor
    points: torch.Tensor
    objects: torch.Tensor
    free_poses: torch.Tensor
    free_points: torch.Tensor
    free_objects: torch.Tensor
    cam_r: torch.Tensor
    cam_t: torch.Tensor
    factors: Dict[str, Dict[str, torch.Tensor]]
    huber: Dict[str, float] = field(default_factory=dict)
    # Rows of the caller's state tables that the problem's poses, points and
    # objects are (None: all).
    keep: Optional[Dict[str, np.ndarray]] = None

    def take(self, poses, objects, points):
        """A state of the caller's full tables, cut to the problem's rows."""
        def cut(x, table):
            x = torch.as_tensor(x, dtype=self.poses.dtype, device=self.poses.device)
            if self.keep is None:
                return x
            return x[torch.as_tensor(self.keep[table], device=x.device)]
        return cut(poses, "poses"), cut(objects, "objects"), cut(points, "points")

    def put(self, x, poses, objects, points):
        """The caller's full state (numpy) with the problem's rows set from
        its own state ``x``."""
        out = []
        for full, part, table in zip((poses, objects, points), x,
                                     ("poses", "objects", "points")):
            full = np.array(full, dtype=np.float64, copy=True)
            rows = slice(None) if self.keep is None else self.keep[table]
            full[rows] = part.detach().double().cpu().numpy()
            out.append(full)
        return tuple(out)

    @property
    def sizes(self):
        return self.poses.shape[0], self.objects.shape[0], self.points.shape[0]

    def state(self):
        return (self.poses, self.objects, self.points)


# ---- row functions ---------------------------------------------------------


def _reproj(pose, point, cam_r, cam_t, obs, mult):
    return mult * (geo.project(pose, point, cam_r, cam_t) - obs)


def _bbox(obj, pose, cam_r, cam_t, corners, sqrt_inf, invalid):
    box, valid = geo.ellipsoid_box(obj, pose, cam_r, cam_t)
    r = (sqrt_inf @ (box - corners)[..., None])[..., 0]
    return torch.where(valid[..., None], r, invalid * torch.ones_like(r))


def _shape(obj, mean, sqrt_inf):
    return (sqrt_inf @ (obj[..., 4:7] - mean)[..., None])[..., 0]


def _relpose(pb, pa, meas_t, meas_r, sqrt_inf):
    rb, ra = geo.exp_so3(pb[..., 3:6]), geo.exp_so3(pa[..., 3:6])
    rbt = rb.transpose(-1, -2)
    rel_t = (rbt @ (pa[..., 0:3] - pb[..., 0:3])[..., None])[..., 0]
    rot = geo.log_so3(rbt @ ra @ meas_r.transpose(-1, -2))
    return (sqrt_inf @ torch.cat([rel_t - meas_t, rot], -1)[..., None])[..., 0]


def _ltm(obj, mean, sqrt_inf):
    return (sqrt_inf @ (obj - mean)[..., None])[..., 0]


def _rows(prob: PlainProblem, name, x):
    """(row function, its block arguments, its other arguments, the blocks'
    (kind, index) per argument) of family ``name`` at state ``x``."""
    poses, objects, points = x
    f = prob.factors[name]
    if name == "reproj":
        c = f["cam"]
        return (_reproj, (poses[f["pose"]], points[f["point"]]),
                (prob.cam_r[c], prob.cam_t[c], f["obs"], f["mult"]),
                (("pose", f["pose"]), ("point", f["point"])))
    if name == "bbox":
        c = f["cam"]
        inv = prob.huber.get("invalid_ellipse_error", 1e6)
        return (lambda o, p, cr, ct, co, si: _bbox(o, p, cr, ct, co, si, inv),
                (objects[f["obj"]], poses[f["pose"]]),
                (prob.cam_r[c], prob.cam_t[c], f["corners"], f["sqrt_inf"]),
                (("obj", f["obj"]), ("pose", f["pose"])))
    if name == "shape":
        return _shape, (objects[f["obj"]],), (f["mean"], f["sqrt_inf"]), (("obj", f["obj"]),)
    if name == "relpose":
        return (_relpose, (poses[f["before"]], poses[f["after"]]),
                (f["meas_t"], f["meas_r"], f["sqrt_inf"]),
                (("pose", f["before"]), ("pose", f["after"])))
    if name == "ltm":
        return _ltm, (objects[f["obj"]],), (f["mean"], f["sqrt_inf"]), (("obj", f["obj"]),)
    raise ValueError(name)


def _prior_values(prob, x):
    f = prob.factors["prior"]
    tables = x[0], x[2], x[1]  # kind 0 pose, 1 point, 2 object
    val = torch.zeros_like(f["mean"])
    for kind, table in enumerate(tables):
        sel = f["kind"] == kind
        if table.shape[0] and bool(sel.any()):
            b = f["block"].clamp(0, table.shape[0] - 1)
            p = f["param"].clamp(0, table.shape[1] - 1)
            val = torch.where(sel, table[b, p], val)
    return f["inv_std"] * (val - f["mean"])


def huber_rho(s, delta):
    d2 = delta * delta
    return torch.where(s <= d2, s, 2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-300)) - d2)


def huber_dweight(s, delta):
    """rho'(s)."""
    return torch.where(s <= delta * delta, torch.ones_like(s),
                       delta / torch.sqrt(torch.clamp(s, min=1e-300)))


def residuals(prob: PlainProblem, name, x):
    fn, blocks, other, _ = _rows(prob, name, x)
    if blocks[0].shape[0] == 0:
        return blocks[0].new_zeros((0, 1))
    return fn(*blocks, *other)


def cost(prob: PlainProblem, x, weights=None) -> torch.Tensor:
    """0.5 * sum w * rho(|r|^2) + 0.5 * sum of the priors' squares, with
    ``weights`` (a dict by family) in place of the rows' own ``w``."""
    weights = weights or {}
    total = prob.poses.new_zeros(())
    for name in ROBUST:
        f = prob.factors[name]
        if f["w"].shape[0] == 0:
            continue
        r = residuals(prob, name, x)
        w = weights.get(name, f["w"])
        total = total + 0.5 * (w * huber_rho((r * r).sum(-1), prob.huber[name])).sum()
    f = prob.factors["prior"]
    if f["w"].shape[0]:
        r = _prior_values(prob, x)
        total = total + 0.5 * (weights.get("prior", f["w"]) * r * r).sum()
    return total


@dataclass
class Linearization:
    """The Gauss-Newton system in [poses | objects] (c) and points (l):
    H = [[A, W], [W^T, V]], g = J^T r, at cost ``cost``."""

    cost: torch.Tensor
    a: torch.Tensor  # (Nc, Nc)
    g_c: torch.Tensor  # (Nc,)
    v: torch.Tensor  # (M, 3, 3)
    g_l: torch.Tensor  # (M, 3)
    w_rows: torch.Tensor  # (F, 6, 3) pose-point blocks of the reprojection rows
    w_pose: torch.Tensor  # (F,) pose of each block
    w_point: torch.Tensor  # (F,) point of each block


def _offsets(prob, kind, idx):
    n_pose = prob.poses.shape[0]
    if kind == "pose":
        return idx * 6, 6
    if kind == "obj":
        return n_pose * 6 + idx * 7, 7
    return idx * 3, 3


def _add_blocks(mat, r_off, r_dim, c_off, c_dim, blocks):
    if blocks.shape[0] == 0:
        return
    ar = torch.arange(r_dim, device=mat.device)
    ac = torch.arange(c_dim, device=mat.device)
    rows = (r_off[:, None, None] + ar[None, :, None]).expand(blocks.shape)
    cols = (c_off[:, None, None] + ac[None, None, :]).expand(blocks.shape)
    mat.index_put_((rows.reshape(-1), cols.reshape(-1)), blocks.reshape(-1), accumulate=True)


def _add_vec(vec, off, dim, vals):
    if vals.shape[0] == 0:
        return
    idx = off[:, None] + torch.arange(dim, device=vec.device)[None, :]
    vec.index_put_((idx.reshape(-1),), vals.reshape(-1), accumulate=True)


def linearize(prob: PlainProblem, x, weights=None) -> Linearization:
    """Robustified Gauss-Newton system at ``x`` (Ceres' scaling by
    sqrt(rho'), whose curvature correction vanishes for Huber). Columns of
    blocks that are not free are zero."""
    weights = weights or {}
    n_pose, n_obj, n_pt = prob.sizes
    nc = n_pose * 6 + n_obj * 7
    dt, dev = prob.poses.dtype, prob.poses.device
    a = torch.zeros((nc, nc), dtype=dt, device=dev)
    g_c = torch.zeros(nc, dtype=dt, device=dev)
    v = torch.zeros((n_pt, 3, 3), dtype=dt, device=dev)
    g_l = torch.zeros((n_pt, 3), dtype=dt, device=dev)
    free = {"pose": prob.free_poses, "obj": prob.free_objects, "point": prob.free_points}
    total = prob.poses.new_zeros(())
    w_rows = torch.zeros((0, 6, 3), dtype=dt, device=dev)
    w_pose = w_point = torch.zeros(0, dtype=torch.long, device=dev)
    for name in ROBUST:
        f = prob.factors[name]
        if f["w"].shape[0] == 0:
            continue
        fn, blocks, other, kinds = _rows(prob, name, x)
        argnums = tuple(range(len(blocks)))

        def single(*args, fn=fn):
            r = fn(*args).to(args[0].dtype)
            return r, r

        jacs, r = vmap(jacfwd(single, argnums=argnums, has_aux=True))(*blocks, *other)
        s = (r * r).sum(-1)
        w = weights.get(name, f["w"])
        total = total + 0.5 * (w * huber_rho(s, prob.huber[name])).sum()
        scale = torch.sqrt(w * huber_dweight(s, prob.huber[name]))[:, None]
        rs = rounded(r * scale)
        js = [rounded(j.to(dt) * scale[..., None] * free[k][i][:, None, None].to(dt))
              for j, (k, i) in zip(jacs, kinds)]
        for j, (k, i) in zip(js, kinds):
            off, dim = _offsets(prob, k, i)
            grad = (j.transpose(1, 2) @ rs[..., None])[..., 0]
            if k == "point":
                g_l.index_add_(0, i, grad)
            else:
                _add_vec(g_c, off, dim, grad)
        for ja, (ka, ia) in zip(js, kinds):
            for jb, (kb, ib) in zip(js, kinds):
                blk = ja.transpose(1, 2) @ jb
                if ka == "point" and kb == "point":
                    v.index_add_(0, ia, blk)
                elif ka == "point" or kb == "point":
                    if ka == "pose" and kb == "point":
                        w_rows, w_pose, w_point = blk, ia, ib
                else:
                    oa, da = _offsets(prob, ka, ia)
                    ob, db = _offsets(prob, kb, ib)
                    _add_blocks(a, oa, da, ob, db, blk)
    f = prob.factors["prior"]
    if f["w"].shape[0]:
        r = _prior_values(prob, x)
        w = weights.get("prior", f["w"])
        total = total + 0.5 * (w * r * r).sum()
        for kind, tname in ((0, "pose"), (1, "point"), (2, "obj")):
            sel = (f["kind"] == kind) & (w > 0)
            if not bool(sel.any()):
                continue
            b, p = f["block"][sel], f["param"][sel]
            jw = f["inv_std"][sel] * free[tname][b].to(dt) * torch.sqrt(w[sel])
            if tname == "point":
                v.index_put_((b, p, p), jw * jw, accumulate=True)
                g_l.index_put_((b, p), jw * torch.sqrt(w[sel]) * r[sel], accumulate=True)
            else:
                off, _ = _offsets(prob, tname, b)
                a.index_put_((off + p, off + p), jw * jw, accumulate=True)
                g_c.index_put_((off + p,), jw * torch.sqrt(w[sel]) * r[sel], accumulate=True)
    return Linearization(total, a, g_c, v, g_l, w_rows, w_pose, w_point)


def step_products(prob: PlainProblem, lin: Linearization, d_c, d_l):
    """g^T d and d^T H d of a step (d_c, d_l)."""
    gd = (lin.g_c * d_c).sum() + (lin.g_l * d_l).sum()
    hd = d_c @ (lin.a @ d_c) + (d_l[:, None, :] @ lin.v @ d_l[:, :, None]).sum()
    if lin.w_rows.shape[0]:
        dp = d_c[:prob.poses.shape[0] * 6].reshape(-1, 6)[lin.w_pose]
        cross = (dp[:, None, :] @ lin.w_rows @ d_l[lin.w_point][:, :, None]).sum()
        hd = hd + 2.0 * cross
    return gd, hd
