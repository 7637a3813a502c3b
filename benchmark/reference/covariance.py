"""The reference's marginal covariances of the objects of a long-term map's
extraction problem, in plain PyTorch and float64.

ObVi-SLAM extracts each object's 7x7 covariance with Ceres' ``Covariance``
on the extraction problem at its state: the robustified, undamped
Gauss-Newton system J^T J (Ceres scales each residual block by
sqrt(rho'), ``factors.linearize``), over the parameter blocks that are in
the problem and not held constant, with the scalar priors of the
rank-deficiency repair among the residuals. Here:

- the feature points are eliminated point by point: S = A - W V^-1 W^T,
  with W formed densely for ``chunk`` points at a time, so that the cell's
  sizes fit;
- a pose or object block is in the problem where it is free and some row
  reads it (its diagonal in J^T J is not zero), a point likewise; the
  others are removed, as Ceres leaves out constant and unused blocks;
- the reduced system of the active blocks is inverted densely
  (``torch.linalg.inv``) and the objects' diagonal blocks are read out.

The repair is judged on its own terms (``repair_uncovered``): the null
directions of the extraction problem without the repair's priors are the
eigenvectors of its active reduced system whose eigenvalues are below
``NULL_TOL`` of its largest, and the parameters that the repair's priors
hold must carry each of them.

Departures from Ceres: Ceres factors the whole system sparsely (its
``SPARSE_QR`` or ``DENSE_SVD`` algorithm) and never forms the Schur
complement; the dense inverse of the Schur complement is the same matrix
up to roundoff. Ceres refuses a rank-deficient system and ObVi-SLAM then
finds the deficient parameters itself; here the null directions come from
a dense eigendecomposition of the reduced system, which resolves an
eigenvalue only to roundoff of the largest (~1e-16 of it in float64), far
below ``NULL_TOL``. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.factors import PlainProblem, linearize

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

POINT_CHUNK = 4096
# An eigenvalue of the reduced system below this share of its largest marks
# a null direction. The program repairs below 1e-12 of it; a lower bar here
# asks the repair to hold only what is null beyond doubt.
NULL_TOL = 1e-13


def reduced_system(prob: PlainProblem, weights=None, chunk: int = POINT_CHUNK):
    """(S, active): the Schur complement of the points in J^T J over the
    [poses | objects] parameters, and which of them are active (whole
    blocks)."""
    x = prob.state()
    lin = linearize(prob, x, weights)
    n_pose, n_obj, n_pt = prob.sizes
    nc = lin.a.shape[0]
    dt, dev = lin.a.dtype, lin.a.device
    s = lin.a.clone()
    diag_l = torch.diagonal(lin.v, dim1=1, dim2=2)
    point_active = (diag_l.abs().sum(-1) > 0) & prob.free_points
    eye = torch.eye(3, dtype=dt, device=dev)
    v_inv = torch.linalg.inv(torch.where(point_active[:, None, None], lin.v, eye))
    v_inv = v_inv * point_active[:, None, None].to(dt)
    r6 = torch.arange(6, device=dev)
    r3 = torch.arange(3, device=dev)
    for lo in range(0, n_pt, chunk):
        hi = min(lo + chunk, n_pt)
        rows = torch.nonzero((lin.w_point >= lo) & (lin.w_point < hi))[:, 0]
        if not rows.numel():
            continue
        blocks = lin.w_rows[rows]
        w = torch.zeros((nc, hi - lo, 3), dtype=dt, device=dev)
        i0 = (lin.w_pose[rows] * 6)[:, None, None] + r6[None, :, None]
        i1 = (lin.w_point[rows] - lo)[:, None, None]
        i2 = r3[None, None, :]
        w.index_put_(tuple(i.expand(blocks.shape).reshape(-1) for i in (i0, i1, i2)),
                     blocks.reshape(-1), accumulate=True)
        wv = torch.einsum("nmi,mij->nmj", w, v_inv[lo:hi]).reshape(nc, -1)
        s = s - wv @ w.reshape(nc, -1).T
    block_diag = torch.diagonal(lin.a).abs()
    pose_on = (block_diag[:n_pose * 6].reshape(n_pose, 6).sum(-1) > 0) & prob.free_poses
    obj_on = (block_diag[n_pose * 6:].reshape(n_obj, 7).sum(-1) > 0) & prob.free_objects
    active = torch.cat([pose_on.repeat_interleave(6), obj_on.repeat_interleave(7)])
    return 0.5 * (s + s.T), active


def marginal_covariances(prob: PlainProblem, weights=None, chunk: int = POINT_CHUNK):
    """Covariances (K, 7, 7) of the problem's objects, NaN where an object
    is not active."""
    s, active = reduced_system(prob, weights, chunk)
    n_pose, n_obj, _ = prob.sizes
    idx = torch.nonzero(active)[:, 0]
    sigma = torch.linalg.inv(s[idx][:, idx])
    pos = torch.full((active.shape[0],), -1, dtype=torch.long, device=s.device)
    pos[idx] = torch.arange(idx.numel(), device=s.device)
    covs = torch.full((n_obj, 7, 7), float("nan"), dtype=s.dtype, device=s.device)
    for k in range(n_obj):
        cols = pos[n_pose * 6 + 7 * k: n_pose * 6 + 7 * (k + 1)]
        if bool((cols >= 0).all()):
            covs[k] = sigma[cols][:, cols]
    return covs


def repair_uncovered(prob: PlainProblem, chunk: int = POINT_CHUNK):
    """(the largest share of a null direction of the problem without its
    scalar priors that lies outside the parameters those priors hold, the
    number of null directions, the smallest eigenvalue of the active
    reduced system over its largest, and the smallest above ``NULL_TOL``).

    The share is 1 - the smallest eigenvalue of N^T D N, N the null
    directions (orthonormal columns) and D the indicator of the prior-held
    parameters: 0 where those parameters hold every null direction whole, 1
    where some combination of null directions has no prior at all; 0 where
    there is no null direction."""
    pri = prob.factors["prior"]
    s, active = reduced_system(prob, {"prior": torch.zeros_like(pri["w"])}, chunk)
    n_pose = prob.sizes[0]
    idx = torch.nonzero(active)[:, 0]
    if not idx.numel():
        return 0.0, 0, float("nan"), float("nan")
    lam, vec = torch.linalg.eigh(s[idx][:, idx])
    rel = lam / lam.abs().max()
    null = rel < NULL_TOL
    above = rel[~null]
    low, gap = float(rel[0]), (float(above[0]) if above.numel() else float("nan"))
    if not bool(null.any()):
        return 0.0, 0, low, gap
    held = torch.zeros(active.shape[0], dtype=s.dtype, device=s.device)
    live = pri["w"] > 0
    col = torch.where(pri["kind"] == 0, pri["block"] * 6, n_pose * 6 + pri["block"] * 7)
    col = (col + pri["param"])[live & (pri["kind"] != 1)]
    held[col] = 1.0
    n = vec[:, null]
    cover = torch.linalg.eigvalsh(n.T @ (held[idx][:, None] * n))
    return max(0.0, 1.0 - float(cover[0])), int(null.sum()), low, gap


def relative_error(program, reference):
    """Largest relative Frobenius error of the program's covariance blocks
    over the reference's (both (K, 7, 7); blocks the reference leaves NaN
    are skipped)."""
    program = torch.as_tensor(program, dtype=torch.float64)
    reference = torch.as_tensor(reference, dtype=torch.float64, device=program.device)
    keep = torch.isfinite(reference).all(-1).all(-1)
    if not bool(keep.any()):
        return float("nan")
    diff = torch.linalg.matrix_norm(program[keep] - reference[keep])
    scale = torch.linalg.matrix_norm(reference[keep])
    err = diff / scale
    return float(torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf"))).max())
