"""The reference's Levenberg-Marquardt solver and two-phase outlier pass, in
plain PyTorch.

``solve`` is a trust-region LM in the manner of Ceres (the step solves
(H + D / radius) d = -g with D the clamped diagonal of H; the radius grows
after a good step and halves, then quarters, after a bad one). Points are
eliminated by their Schur complement: dense when the pose-point block is
small, else from every pair of observations of a point. ``two_phase`` runs
phase 1, drops the worst share of the reprojection and bounding-box rows at
its optimum and re-applies the factor-selection rules of ObVi-SLAM's
two-phase optimization (at least so many observations per feature, per frame
and per object; the priors of included objects), then runs phase 2 from the
initial state. ``suboptimality`` judges a state against the reference's own
optimum; ``first_step`` is the first iteration from a state, whose step norm
a program's first step is held to.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.factors import (PlainProblem, cost, linearize, residuals, rounded,
                                         step_products)

# Elements of the dense pose-point block above which the Schur complement
# is formed from the pairs of observations of each point instead.
DENSE_W_LIMIT = 50_000_000
# Pair blocks formed at once by the pair path.
PAIR_CHUNK = 1 << 21


@dataclass
class LMSettings:
    max_iterations: int = 100
    function_tolerance: float = 1e-6
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_relative_decrease: float = 1e-3


@dataclass
class TwoPhaseSettings:
    outlier_share: float = 0.1
    min_feature_observations: int = 3
    min_frame_observations: int = 50
    min_object_observations: int = 1
    include_visual: bool = True
    include_objects: bool = True
    include_shape_priors: bool = True
    fix_objects: bool = False
    fix_ltm_objects: bool = False
    force_include_ltm_objects: bool = False


def _add(x, d_c, d_l):
    poses, objects, points = x
    n_p = poses.numel()
    return (poses + d_c[:n_p].reshape(poses.shape),
            objects + d_c[n_p:].reshape(objects.shape),
            points + d_l.reshape(points.shape))


def _pairs(point, n_pt):
    """(a, b) of every ordered pair of rows observing one point."""
    counts = torch.bincount(point, minlength=n_pt)
    order = torch.argsort(point, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    n_row = counts[point[order]]
    a = torch.repeat_interleave(order, n_row)
    first = torch.cumsum(n_row, 0) - n_row
    k = torch.arange(a.shape[0], device=point.device) - torch.repeat_interleave(first, n_row)
    b = order[starts[point[a]] + k]
    return a, b


def schur_step(prob: PlainProblem, lin, radius):
    """The damped step (d_c, d_l), or None where the reduced system is not
    positive definite."""
    n_pose = prob.poses.shape[0]
    n_pt = prob.points.shape[0]
    nc = lin.a.shape[0]
    dt, dev = lin.a.dtype, lin.a.device
    diag_c = torch.diagonal(lin.a)
    active_c = diag_c > 0
    damp_c = torch.clamp(diag_c, 1e-6, 1e32) / radius
    a = lin.a + torch.diag(torch.where(active_c, damp_c, torch.ones_like(damp_c)))
    diag_l = torch.diagonal(lin.v, dim1=1, dim2=2)
    active_l = diag_l > 0
    damp_l = torch.clamp(diag_l, 1e-6, 1e32) / radius
    v = lin.v + torch.diag_embed(torch.where(active_l, damp_l, torch.ones_like(damp_l)))
    v_inv = rounded(torch.linalg.inv(v)) if n_pt else v
    rhs = -lin.g_c.clone()
    rows = rounded(lin.w_rows)
    if rows.shape[0] and n_pt:
        pose_off = lin.w_pose * 6
        if nc * 3 * n_pt <= DENSE_W_LIMIT:
            w = torch.zeros((nc, n_pt, 3), dtype=dt, device=dev)
            shape = rows.shape
            i0 = (pose_off[:, None, None] + torch.arange(6, device=dev)[None, :, None])
            i1 = lin.w_point[:, None, None]
            i2 = torch.arange(3, device=dev)[None, None, :]
            w.index_put_(tuple(i.expand(shape).reshape(-1) for i in (i0, i1, i2)),
                         rows.reshape(-1), accumulate=True)
            wv = rounded(torch.einsum("nmi,mij->nmj", w, v_inv).reshape(nc, 3 * n_pt))
            a = a - wv @ w.reshape(nc, 3 * n_pt).T
            rhs = rhs + wv @ lin.g_l.reshape(-1)
        else:
            a_idx, b_idx = _pairs(lin.w_point, n_pt)
            r6 = torch.arange(6, device=dev)
            for lo in range(0, a_idx.shape[0], PAIR_CHUNK):
                ia, ib = a_idx[lo:lo + PAIR_CHUNK], b_idx[lo:lo + PAIR_CHUNK]
                blk = rounded(rows[ia] @ v_inv[lin.w_point[ia]]) @ rows[ib].transpose(1, 2)
                ro = (pose_off[ia][:, None, None] + r6[None, :, None]).expand(blk.shape)
                co = (pose_off[ib][:, None, None] + r6[None, None, :]).expand(blk.shape)
                a.index_put_((ro.reshape(-1), co.reshape(-1)), -blk.reshape(-1), accumulate=True)
            wg = (rows @ (v_inv[lin.w_point] @ lin.g_l[lin.w_point][..., None]))[..., 0]
            rhs.index_put_(((pose_off[:, None] + r6).reshape(-1),), wg.reshape(-1),
                           accumulate=True)
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) != 0:
        return None
    d_c = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    d_c = torch.where(active_c, d_c, torch.zeros_like(d_c))
    back = -lin.g_l.clone()
    if rows.shape[0] and n_pt:
        dp = d_c[:n_pose * 6].reshape(n_pose, 6)[lin.w_pose]
        back.index_add_(0, lin.w_point, -(rows.transpose(1, 2) @ dp[..., None])[..., 0])
    d_l = (v_inv @ back[..., None])[..., 0] if n_pt else back
    d_l = torch.where(active_l, d_l, torch.zeros_like(d_l))
    return d_c, d_l


def solve(prob: PlainProblem, x0, weights=None, settings: LMSettings = LMSettings()):
    """LM from ``x0`` = (poses, objects, points): (state, cost, iterations)."""
    x = x0
    lin = linearize(prob, x, weights)
    f = float(lin.cost)
    radius, factor = settings.initial_radius, 2.0
    it = 0
    while it < settings.max_iterations:
        it += 1
        step = schur_step(prob, lin, radius)
        if step is not None:
            gd, hd = step_products(prob, lin, *step)
            model = -(float(gd) + 0.5 * float(hd))
            x_new = _add(x, *step)
            f_new = float(cost(prob, x_new, weights))
            rho = (f - f_new) / model if model > 0 else -1.0
        if step is not None and math.isfinite(f_new) and rho > settings.min_relative_decrease:
            decrease = f - f_new
            x = x_new
            radius = min(settings.max_radius,
                         radius / max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3))
            factor = 2.0
            lin = linearize(prob, x, weights)
            f_prev, f = f, float(lin.cost)
            if decrease <= settings.function_tolerance * f_prev:
                break
        else:
            radius /= factor
            factor *= 2.0
            if radius < settings.min_radius:
                break
    return x, f, it


def first_step(prob: PlainProblem, x0, weights=None, settings: LMSettings = LMSettings()):
    """The first LM iteration from ``x0`` at the initial radius: (cost
    before it, its cost decrease, its step's norm), the decrease and the norm
    0 where the step is not accepted."""
    lin = linearize(prob, x0, weights)
    f0 = float(lin.cost)
    step = schur_step(prob, lin, settings.initial_radius)
    if step is None:
        return f0, 0.0, 0.0
    gd, hd = step_products(prob, lin, *step)
    model = -(float(gd) + 0.5 * float(hd))
    f1 = float(cost(prob, _add(x0, *step), weights))
    rho = (f0 - f1) / model if model > 0 else -1.0
    if not (math.isfinite(f1) and rho > settings.min_relative_decrease):
        return f0, 0.0, 0.0
    norm = math.sqrt(float((step[0] * step[0]).sum() + (step[1] * step[1]).sum()))
    return f0, f0 - f1, norm


def norm_gap(norm, norm_ref):
    """How far a step's norm lies from the reference's, as a share of it."""
    return abs(norm - norm_ref) / max(norm_ref, 1e-30)


def _outliers(sq, live, share):
    """The worst ``share`` of the live rows by squared residual (a stable
    ranking; the count floor(n_live * share) in float32)."""
    n_out = int(np.floor(np.float32(int(live.sum())) * np.float32(share)))
    neg = torch.where(live, sq, torch.full_like(sq, -float("inf")))
    order = torch.argsort(-neg, stable=True)
    out = torch.zeros_like(live)
    out[order[:n_out]] = True
    return out & live


def select_phase_two(prob: PlainProblem, x1, tp: TwoPhaseSettings, is_ltm_obj, shape_live):
    """Phase-2 weights by family from the phase-1 optimum ``x1``."""
    n_pose, n_obj, n_pt = prob.sizes
    f = prob.factors
    dt = prob.poses.dtype
    rp, bb = f["reproj"], f["bbox"]

    def sq(name):
        if f[name]["w"].shape[0] == 0:
            return f[name]["w"].clone()
        r = residuals(prob, name, x1)
        return (r * r).sum(-1)

    def count(keep, idx, n):
        return torch.zeros(n, dtype=dt, device=keep.device).index_add_(0, idx, keep.to(dt))

    rp_keep = rp["mask"] & ~_outliers(sq("reproj"), rp["mask"] & (rp["w"] > 0), tp.outlier_share)
    bb_keep = bb["mask"] & ~_outliers(sq("bbox"), bb["mask"] & (bb["w"] > 0), tp.outlier_share)
    feat = count(rp_keep, rp["point"], n_pt)
    rp_keep = rp_keep & (feat[rp["point"]] >= tp.min_feature_observations)
    if not tp.include_visual:
        rp_keep = torch.zeros_like(rp_keep)
    rl = f["relpose"]
    if tp.min_frame_observations > 0 and tp.include_visual:
        starved = count(rp_keep, rp["pose"], n_pose) < tp.min_frame_observations
        rl_keep = rl["mask"] & (starved[rl["before"]] | starved[rl["after"]])
    else:
        rl_keep = torch.zeros_like(rl["mask"])
    obj_count = count(bb_keep, bb["obj"], n_obj)
    included = ((obj_count >= tp.min_object_observations) | is_ltm_obj) & (obj_count > 0)
    bb_keep = bb_keep & included[bb["obj"]]
    if not tp.include_objects:
        bb_keep = torch.zeros_like(bb_keep)
        included = torch.zeros_like(included)
    if tp.include_objects and not tp.fix_objects:
        if tp.fix_ltm_objects:
            with_priors = included & ~is_ltm_obj
        else:
            with_priors = included | is_ltm_obj if tp.force_include_ltm_objects else included
    else:
        with_priors = torch.zeros_like(included)
    sh, lt = f["shape"], f["ltm"]
    sh_keep = (sh["mask"] & shape_live & with_priors[sh["obj"]] if tp.include_shape_priors
               else torch.zeros_like(sh["mask"]))
    lt_keep = lt["mask"] & with_priors[lt["obj"]]
    return {"reproj": rp_keep.to(dt), "bbox": bb_keep.to(dt), "shape": sh_keep.to(dt),
            "relpose": rl_keep.to(dt), "ltm": lt_keep.to(dt), "prior": f["prior"]["w"]}


def two_phase(prob: PlainProblem, tp: TwoPhaseSettings, settings1: LMSettings,
              settings2: LMSettings, is_ltm_obj, shape_live):
    """Phase 1, the re-selection and phase 2 from the initial state:
    (state, cost, phase-2 weights, iterations of both phases)."""
    x0 = prob.state()
    x1, _, it1 = solve(prob, x0, None, settings1)
    w2 = select_phase_two(prob, x1, tp, is_ltm_obj, shape_live)
    x2, c2, it2 = solve(prob, x0, w2, settings2)
    return x2, c2, w2, it1 + it2


def suboptimality(prob: PlainProblem, x, x_ref, weights=None):
    """(C(x) - C(x_ref)) / (C(x0) - C(x_ref)): the share of the decrease
    from the initial state to the reference's optimum that ``x`` misses
    (0 at the optimum, 1 for the initial state), under ``weights``."""
    c = float(cost(prob, x, weights))
    c_ref = float(cost(prob, x_ref, weights))
    c0 = float(cost(prob, prob.state(), weights))
    room = max(c0 - c_ref, 1e-9 * abs(c_ref), 1e-30)
    return (c - c_ref) / room
