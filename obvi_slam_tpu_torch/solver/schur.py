"""One damped Gauss-Newton (LM) step by Schur complement.

Counterpart of ``obvi_slam_tpu/solver/schur.py::compute_step``: points
(3-D) and objects (7-dof ellipsoids) are eliminated through batched
small-block inverses, and the reduced pose system S (6P x 6P) is assembled
and solved densely:

  residuals + J (kernels K1, K2) -> Huber row weights -> H/b block sums
  -> LM damping -> 3x3 / 7x7 SPD inverse and factor G (H^-1 = G G^T)
  -> W pair blocks -> Schur subtraction -> S -> Cholesky + one refinement
  step -> back-substitution -> model cost change.

``choose_paths`` picks how S is built, as the reference does for
``dense_schur=None`` (its ``schur.py:1543-1613``):
  - slot grams (``dense_schur``): the Schur subtraction is the gram of
    (W G) placed on the plan's per-landmark slot grid. Dense layout
    (pose-major S): the point gram is one (3L, 6P) gram, through kernel K4
    where the reference's syrk gate holds; the relpose and damped-diagonal
    blocks enter as the gram V_rel V_rel^T. Banded layout (the plan carries
    ``pt_band_local_pose``, from 192 poses): the point gram is G group grams
    over 128-pose local windows (kernel K3), folded onto a component-major
    S; the object gram is c-major too, and the relpose and diagonal blocks
    are scattered on directly.
  - dense-from-pairs: a slot grid over ``_SLOT_BUDGET`` elements (a
    landmark seen from poses far apart: loop closures) is replaced by the
    dense (6P, 3M) / (6P, 7K) U built by scatter, and its gram U U^T.
  - pair enumeration (U over ``_DENSE_U_LIMIT`` elements): every cross
    block -W_a H^-1 W_b^T, summed by destination, the relpose blocks and the
    damped diagonal land in one accumulating scatter into S, which is then
    symmetrized.

From 512 poses (``_use_band_solve``) a banded problem is not assembled into
S at all: the group grams' 64-pose quadrants and the relpose and diagonal
blocks go onto block-tridiagonal tiles, the object z becomes the low-rank
term, and ``band_solve.woodbury_band_solve`` solves S = B - Z^T Z.

Other grams are plain float32/float64 matmuls; on the card TF32 must stay
off (``torch.backends.cuda.matmul.allow_tf32 = False``), which the caller
sets. ``path_counts`` counts the paths each step took.

With a ``mesh`` (``parallel.sharding``) each rank holds its shard of the
factor tables and cross rows (``shard_problem``) and the whole replicated
rest; the reference's GSPMD partitioning becomes explicit collectives
(``parallel.comm``):
  - K1, K2 and every factor family run on the rank's rows; the H/b block
    sums, the prior diagonals and the W pair blocks are partial and combine
    in one all_reduce;
  - the relpose rows' Jacobians are all_gathered for S's relpose blocks;
  - the grams take the rank's landmark rows (K4's, K3's rows of every
    group; the reference's ``_shard_rows``), the pair enumeration its cross
    rows, and the partial S (or band quadrants, or destination blocks)
    combines in one all_reduce; the path choice and the syrk gate read the
    global problem, so no path depends on the rank count;
  - the reduced RHS and the back-substitution run replicated from the pair
    blocks; a dense solve runs replicated; a band solve is domain-decomposed
    over ``_dd_domains`` domains: one per rank (the tiles go deferred to
    ``band_solve._dd_rank_solve``) when they number the ranks, else batched;
  - the step is broadcast from rank 0, so every rank holds it bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import geometry as geo
from obvi_slam_tpu_torch import ops
from obvi_slam_tpu_torch.ops import band_gram, syrk
from obvi_slam_tpu_torch.parallel import comm, sharding
from obvi_slam_tpu_torch.solver import band_solve
from obvi_slam_tpu_torch.solver.plan import BAND_TP
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
# back to the dense U built from the pairs (schur.py:1557; tests patch it).
_SLOT_BUDGET = 48 * 1024 * 1024
# Largest dense U (elements) of the automatic choice; above it the step
# enumerates pairs (schur.py:1580).
_DENSE_U_LIMIT = 256 * 1024 * 1024
# Block-tridiagonal + Woodbury reduced solve: "auto" takes it from
# _BAND_SOLVE_MIN_POSES poses where the banded layout allows it (see
# compute_step); "on" / "off" force it (tests set these with monkeypatch).
_BAND_SOLVE = "auto"
_BAND_SOLVE_MIN_POSES = 512


def _use_band_solve(n_pose) -> bool:
    if _BAND_SOLVE == "off":
        return False
    if _BAND_SOLVE == "on":
        return True
    return n_pose is not None and n_pose >= _BAND_SOLVE_MIN_POSES


# Domain decomposition of the band solve over a mesh: "auto" takes
# _dd_domains' count, "off" keeps the whole band on every rank.
_BAND_DD = "auto"


def _dd_domains(mesh, nb: int) -> int:
    """Domains of the band solve: the largest power of two h <= the mesh
    size that divides nb with >= 2 tiles per domain; 1 = no decomposition."""
    if _BAND_DD == "off" or mesh is None:
        return 1
    h = int(mesh.size)
    while h > 1 and (nb % h != 0 or nb // h < 2):
        h //= 2
    return max(h, 1)


def _all_reduce_packed(tensors, mesh):
    """Sum over the ranks of several tensors through one all_reduce."""
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def _gather_rows(tensors, mesh):
    """Every rank's rows of several (R, ...) tensors, concatenated in rank
    order, through one all_gather (integer and bool columns ride as floats)."""
    dtype = next(t.dtype for t in tensors if t.is_floating_point())
    cols = [t.reshape(t.shape[0], -1).to(dtype) for t in tensors]
    gathered = comm.all_gather(torch.cat(cols, 1), mesh).flatten(0, 1)
    parts = torch.split(gathered, [c.shape[1] for c in cols], dim=1)
    return [p.reshape((-1,) + tuple(t.shape[1:])) if t.is_floating_point()
            else p.round().to(t.dtype).reshape((-1,) + tuple(t.shape[1:]))
            for p, t in zip(parts, tensors)]


class SchurPaths(NamedTuple):
    """How one step builds and solves S (``choose_paths``)."""

    dense: bool  # slot grams / dense-from-pairs; False: pair enumeration
    pt_band: bool  # the plan's banded point layout covers the poses
    pt_slot: bool  # the point slot grid is within budget
    ob_slot: bool  # the object slot grid is within budget
    cp_order: bool  # S in (component, pose)-major order
    band_solve: bool  # block-tridiagonal + Woodbury solve

    def labels(self):
        """The names ``path_counts`` counts this step under."""
        if not self.dense:
            return ("pair_enumeration",)
        pt = "pt_band_slot" if self.pt_band and self.pt_slot else (
            "pt_slot" if self.pt_slot else "pt_dense_from_pairs")
        ob = "ob_slot" if self.ob_slot else "ob_dense_from_pairs"
        return (pt, ob) + (("band_solve",) if self.band_solve else ())


def choose_paths(plan, n_pose, n_point, dense_schur=None) -> SchurPaths:
    """The reference's path choice (schur.py:1543-1613) from the plan's
    array shapes, the pose count and the point count. ``dense_schur`` None
    is automatic: slot grams or dense-from-pairs while the dense U (or, on
    the banded layout, the group z) stays within ``_DENSE_U_LIMIT``
    elements, pair enumeration above it.

    Unlike the reference, S is (component, pose)-major only on the slot-gram
    path: pair enumeration assembles a pose-major S whatever the layout."""
    band_local = plan.pt_band_local_pose
    pt_band = band_local is not None and n_pose <= BAND_TP * (band_local.shape[0] + 1)
    pt_onehot_width = 2 * BAND_TP if pt_band else n_pose
    pt_lc = plan.pt_slot_gather.shape
    ob_lc = plan.ob_slot_gather.shape
    pt_slot = pt_lc[0] * pt_lc[1] * pt_onehot_width <= _SLOT_BUDGET
    ob_slot = ob_lc[0] * ob_lc[1] * n_pose <= _SLOT_BUDGET
    if dense_schur is None:
        if pt_band and pt_slot:
            lp = band_local.shape
            u_elems = lp[0] * lp[1] * 3 * 6 * 2 * BAND_TP
        else:
            u_elems = (n_pose * 6) * (n_point * 3)
        dense_schur = u_elems <= _DENSE_U_LIMIT
    dense_schur = bool(dense_schur)
    cp_order = dense_schur and pt_band and pt_slot
    band_solve_on = (
        cp_order
        and ob_slot
        and _use_band_solve(n_pose)
        and n_pose % BAND_TP == 0
        and plan.rel_band_local_pose is not None
        and ob_lc[0] * 7 <= 3 * n_pose
    )
    return SchurPaths(dense_schur, pt_band, pt_slot, ob_slot, cp_order, band_solve_on)


# Steps per path since the last reset_path_counts(): "steps", and each of
# SchurPaths.labels(). A replayed CUDA graph adds the steps of its capture.
path_counts: dict = {}


def reset_path_counts() -> None:
    path_counts.clear()


def add_path_counts(counts: dict) -> None:
    """Adds {path: steps} to ``path_counts`` (a CUDA graph's replay)."""
    for name, n in counts.items():
        path_counts[name] = path_counts.get(name, 0) + n


def _count_paths(paths: SchurPaths) -> None:
    for name in ("steps",) + paths.labels():
        path_counts[name] = path_counts.get(name, 0) + 1


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


def _syrk_gate(n_land, n_cols):
    """Where the reference takes its syrk gram (schur.py:1509-1510): at least
    1024 landmark rows in multiples of 256, and 6P a multiple of a tile."""
    tile_fits = any(n_cols % t == 0 for t in (384, 256, 128))
    return n_land >= 1024 and n_land % 256 == 0 and tile_fits


def _slot_gram(
    w_scaled, slot_gather, slot_pose, slot_mask, n_pose, cp_order=False, plain=False,
    skip_gram=False, rows=None,
):
    """Schur subtraction sum_l (W_l G_l)(W_l G_l)^T through the slot grid.

    Each live slot (l, c) places its (6, bw) pair block at pose row
    slot_pose[l, c] of landmark l; (pose, landmark) pairs are unique, so every
    entry of z receives one block (dead slots add zeros). Returns S_sub
    (6P, 6P) and z flattened to rows (landmark, block column) by columns
    (pose, component), or (component, pose) with ``cp_order``. The pose-major
    gram goes through kernel K4 where the reference's syrk gate holds. With
    ``skip_gram`` (band solve: z is the Woodbury term) S_sub is None. With
    ``rows`` (lo, hi) only those landmark rows enter (a rank's partial
    gram); the syrk gate still reads the whole grid."""
    gate_rows = slot_gather.shape[0]
    if rows is not None:
        slot_gather, slot_pose, slot_mask = (x[rows[0]: rows[1]]
                                             for x in (slot_gather, slot_pose, slot_mask))
    n_land, n_slot = slot_gather.shape
    bw = w_scaled.shape[-1]
    w_comp = w_scaled.reshape(-1, 6 * bw)[slot_gather.reshape(-1).long()]
    w_comp = w_comp * slot_mask.reshape(-1, 1).to(w_comp.dtype)
    land = torch.arange(n_land, device=slot_pose.device)[:, None]
    rows = (land * n_pose + slot_pose.long()).reshape(-1)
    z = w_scaled.new_zeros((n_land * n_pose, 6 * bw)).index_add_(0, rows, w_comp)
    perm = (0, 3, 2, 1) if cp_order else (0, 3, 1, 2)
    zf = z.reshape(n_land, n_pose, 6, bw).permute(*perm).reshape(n_land * bw, n_pose * 6)
    if skip_gram:
        return None, zf
    if not cp_order and _syrk_gate(gate_rows, 6 * n_pose):
        gram = syrk.syrk_gram_plain if plain else ops.syrk_gram
        return gram(zf.contiguous()), zf
    return zf.T @ zf, zf


def _band_slot_gram(
    w_scaled, slot_gather, slot_mask, band_local, n_pose, plain=False, emit_tiles=False,
    rows=None,
):
    """Banded point gram: the slot grid's rows form G groups of Lg landmarks
    whose poses lie in a 128-pose window starting at pose 64 g. Kernel K3
    builds each group's z (G, 3 Lg, 768), rows (landmark, block column) and
    columns (component, local pose), and its gram. Returns (S_sub, z): the
    overlapping group grams (stride 64, width 128) summed onto a c-major
    S_sub (6P, 6P), index c P + p; or, with ``emit_tiles`` (band solve), the
    three quadrants (q00, q10, q11), each (G, 6, 64, 6, 64), that group g's
    gram places on tiles (g, g), (g + 1, g) and (g + 1, g + 1), unfolded.
    With ``rows`` (lo, hi) only those landmarks of every group enter (a
    rank's partial grams)."""
    if rows is not None:
        shape = band_local.shape
        band_local, slot_gather, slot_mask = (
            x.reshape(shape)[:, rows[0]: rows[1]]
            for x in (band_local, slot_gather, slot_mask))
        slot_gather, slot_mask = (x.reshape(-1, shape[2]) for x in (slot_gather, slot_mask))
    n_group, lg, n_slot = band_local.shape
    n_land = n_group * lg
    bw = w_scaled.shape[-1]
    w_comp = w_scaled.reshape(-1, 6 * bw)[slot_gather.reshape(-1).long()]
    w_rows = (
        w_comp.reshape(n_land, n_slot, 6, bw).permute(0, 3, 1, 2)
        .reshape(n_group, lg * bw, n_slot * 6)
    )  # row (l, b), column (slot, component)
    lp = band_local.reshape(n_land, n_slot).masked_fill(~slot_mask, band_gram.WIDTH)
    lp_rows = lp.to(torch.int32)[:, None, :].expand(n_land, bw, n_slot).reshape(
        n_group, lg * bw, n_slot
    )
    build = band_gram.band_zbuild_gram_plain if plain else ops.band_zbuild_gram
    z, s_group = build(w_rows.contiguous(), lp_rows.contiguous())
    if emit_tiles:
        s6 = s_group.reshape(n_group, 6, 2, BAND_TP, 6, 2, BAND_TP)
        return (s6[:, :, 0, :, :, 0], s6[:, :, 1, :, :, 0], s6[:, :, 1, :, :, 1]), z
    width = band_gram.WIDTH
    s_pad = s_group.new_zeros((6, BAND_TP * (n_group + 1), 6, BAND_TP * (n_group + 1)))
    for g in range(n_group):
        win = slice(BAND_TP * g, BAND_TP * g + width)
        s_pad[:, win, :, win] += s_group[g].reshape(6, width, 6, width)
    return s_pad[:, :n_pose, :, :n_pose].reshape(6 * n_pose, 6 * n_pose), z


def _band_tiles(quads, rows_blk, cols_blk, vals):
    """Block-tridiagonal tiles of S from the point gram's quadrants and the
    (P-index) blocks ``vals`` at (rows_blk, cols_blk): d (nb, 384, 384) and
    e (nb - 1, 384, 384), e[i] = S[tile i + 1, tile i], in c-major-within-
    tile order. The quadrants' overlap (q11 of group g - 1 and q00 of group
    g on tile g) is folded and negated (S = blocks - gram); blocks above the
    diagonal tiles are left out (each cross block's transpose twin is in
    ``vals``), and they, like the last group's padding tile, land on a spare
    tile that is sliced off."""
    q00, q10, q11 = quads
    nb = q00.shape[0]
    d = -q00
    d[1:] -= q11[:-1]
    e = torch.cat([-q10[:-1], torch.zeros_like(q10[:1])])  # spare tile nb - 1
    d = torch.cat([d, torch.zeros_like(d[:1])])  # spare tile nb
    t_r, t_c = rows_blk // BAND_TP, cols_blk // BAND_TP
    pl_r, pl_c = rows_blk % BAND_TP, cols_blk % BAND_TP
    ci = torch.arange(6, device=vals.device)

    def index(dest):
        return (dest[:, None, None], ci[None, :, None], pl_r[:, None, None],
                ci[None, None, :], pl_c[:, None, None])

    d.index_put_(index(torch.where(t_r == t_c, t_r, nb)), vals, accumulate=True)
    e.index_put_(index(torch.where(t_r == t_c + 1, t_c, nb - 1)), vals, accumulate=True)
    m = 6 * BAND_TP
    return d[:nb].reshape(nb, m, m), e[: nb - 1].reshape(nb - 1, m, m)


def _dense_from_pairs(row_blk, col_blk, live, blocks, n_pose, n_col, cp_order=False):
    """Dense (6P, bw n_col) block matrix with block (row_blk[k], col_blk[k])
    = blocks[k] (K, 6, bw); rows (pose, component), or (component, pose)
    with ``cp_order``. Live (row, column) blocks are unique; dead rows land
    on a spare row block that is dropped."""
    k, bh, bw = blocks.shape
    device = blocks.device
    safe = torch.where(live, row_blk.long(), n_pose)
    if cp_order:
        rows = torch.arange(bh, device=device) * (n_pose + 1) + safe[:, None]
    else:
        rows = safe[:, None] * bh + torch.arange(bh, device=device)
    cols = col_blk.long()[:, None] * bw + torch.arange(bw, device=device)
    out = blocks.new_zeros(((n_pose + 1) * bh, n_col * bw))
    out[rows[:, :, None].expand(k, bh, bw), cols[:, None, :].expand(k, bh, bw)] = blocks
    if cp_order:
        return out.reshape(bh, n_pose + 1, n_col * bw)[:, :n_pose].reshape(bh * n_pose, -1)
    return out[: n_pose * bh]


def _cross_blocks(w, pair_land, cross_a, cross_b, cross_mask, cross_dest, dest_mask,
                  h_inv=None):
    """Schur cross blocks -W_a H^-1 W_b^T of every ordered pair-row pair
    that shares a landmark, summed by destination block of S: (Nd, 6, 6).
    Without ``h_inv``, ``w`` holds the scaled pair blocks W G (H^-1 = G G^T)
    and the blocks are -(W_a G)(W_b G)^T."""
    cross_a, cross_b = cross_a.long(), cross_b.long()
    w_a = w[cross_a]
    if h_inv is not None:
        w_a = geo.bmm(w_a, h_inv[pair_land.long()[cross_a]])
    cross = -geo.bmm(w_a, w[cross_b].transpose(1, 2))
    cross = cross * cross_mask[:, None, None].to(w.dtype)
    dest = _segment_sum(cross, cross_dest, dest_mask.shape[0])
    return dest * dest_mask[:, None, None].to(w.dtype)


def _pair_enumeration_s(n_pose, diag_blocks, rl_idx, rl_cross, plan, w_scaled, w_ob_scaled,
                        mesh=None):
    """Pose-major S (6P, 6P) by pair enumeration (schur.py:1837-1879): the
    masked damped diagonal, each relpose factor's cross blocks at (before,
    after) = ``rl_idx`` and their transposes, and the point and object cross
    blocks from the scaled pair blocks W G in one accumulating scatter, then
    0.5 (S + S^T) (schur.py:2043-2044). Dead relpose and destination rows
    carry index 0 and zero blocks. With a ``mesh`` the cross rows are the
    rank's and their destination sums combine in one all_reduce."""
    p_rng = torch.arange(n_pose, device=diag_blocks.device)
    bidx, aidx = rl_idx
    dest_pt = _cross_blocks(w_scaled, plan.pt_pair_point, plan.pt_cross_a, plan.pt_cross_b,
                            plan.pt_cross_mask, plan.pt_cross_dest, plan.pt_dest_mask)
    dest_ob = _cross_blocks(w_ob_scaled, plan.ob_pair_obj, plan.ob_cross_a, plan.ob_cross_b,
                            plan.ob_cross_mask, plan.ob_cross_dest, plan.ob_dest_mask)
    if mesh is not None:
        dest_pt, dest_ob = _all_reduce_packed((dest_pt, dest_ob), mesh)
    idx_a = torch.cat([p_rng, bidx, aidx, plan.pt_dest_a.long(), plan.ob_dest_a.long()])
    idx_b = torch.cat([p_rng, aidx, bidx, plan.pt_dest_b.long(), plan.ob_dest_b.long()])
    vals = torch.cat([diag_blocks, rl_cross, rl_cross.transpose(1, 2), dest_pt, dest_ob])
    return _scatter_blocks(n_pose, idx_a, idx_b, vals)


def _scatter_blocks(n_pose, idx_a, idx_b, vals):
    """0.5 (S + S^T) of the pose-major S (6P, 6P) that sums each 6x6 block
    vals[k] onto block (idx_a[k], idx_b[k]) (duplicates add up)."""
    ci = torch.arange(6, device=vals.device)
    s4 = vals.new_zeros((n_pose, 6, n_pose, 6))
    s4.index_put_(
        (idx_a[:, None, None], ci[None, :, None], idx_b[:, None, None], ci[None, None, :]),
        vals, accumulate=True,
    )
    s = s4.reshape(6 * n_pose, 6 * n_pose)
    return 0.5 * (s + s.T)


def compute_step(
    state: BAState,
    cams,
    tables,
    plan,
    free,
    weights: FactorWeights,
    radius,
    huber: HuberParams = HuberParams(),
    dense_schur=None,
    plain: bool = False,
    mesh=None,
):
    """One LM step: returns (delta: BAState, model_cost_change, grad_max),
    the last two as 0-dim tensors.

    The trust-region radius (a float, or a 0-dim tensor on the state's
    device, as the fused solves pass it) enters as Ceres' damping
    H + diag(clamp(diag(H))) / radius. ``dense_schur`` None chooses the
    path (``choose_paths``); True forces the slot-gram / dense-from-pairs
    path, False pair enumeration. ``plain`` evaluates K1-K4 with their plain
    PyTorch versions on any device (reference runs); otherwise the wrappers
    launch the CUDA kernels for CUDA tensors. With ``mesh`` the tables,
    weights and plan are this rank's shard (``parallel.shard_problem``) and
    the outputs are equal on every rank (see the module docstring)."""
    if mesh is not None:
        sharding.check_mesh(mesh)
    dtype = state.poses.dtype
    n_pose = state.poses.shape[0]
    n_point = state.points.shape[0]
    n_obj = state.objects.shape[0]
    paths = choose_paths(plan, n_pose, n_point, dense_schur)
    _count_paths(paths)
    band_local = plan.pt_band_local_pose
    pt_band, cp_order, band_solve_on = paths.pt_band, paths.cp_order, paths.band_solve

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

    priors = [prior_accum(0, pose_free, n_pose, 6, pp_w2),
              prior_accum(1, point_free, n_point, 3, pp_w2),
              prior_accum(2, obj_free, n_obj, 7, pp_w2),
              prior_accum(0, pose_free, n_pose, 6, -grad_pp),
              prior_accum(1, point_free, n_point, 3, -grad_pp),
              prior_accum(2, obj_free, n_obj, 7, -grad_pp)]

    # ---- W pair blocks ---------------------------------------------------
    def pair_blocks(j_pose, j_land, pair_factor, factor_pair, pair_mask):
        n_pair, d = pair_mask.shape[0], j_land.shape[-1]
        outer = _outer_rr(j_pose, j_land).reshape(-1, 6 * d)
        if pair_factor is not None and mesh is None:
            return outer[pair_factor.long()].reshape(n_pair, 6, d)
        return _segment_sum(outer, factor_pair, n_pair).reshape(n_pair, 6, d)

    w_pt = pair_blocks(j_rp_pose, j_rp_point, plan.pt_pair_factor, plan.rp_factor_pair,
                       plan.pt_pair_mask)
    w_ob = pair_blocks(j_bb_pose, j_bb_obj, plan.ob_pair_factor, plan.bb_factor_pair,
                       plan.ob_pair_mask)

    # Relpose rows for S's relpose blocks: (before, after, live, J_b, J_a).
    rl_rows = (rl.before_idx.long(), rl.after_idx.long(), rl.mask, j_rl_b, j_rl_a)
    if mesh is not None:
        # Partial sums of the rank's factor rows -> whole, on every rank.
        ll_out, oo_out, pp_out, pp_rel_out, w_pt, w_ob, *priors = _all_reduce_packed(
            [ll_out, oo_out, pp_out, pp_rel_out[:, :36], w_pt, w_ob, *priors], mesh)
        rl_rows = tuple(_gather_rows(rl_rows, mesh))
        h_ll = ll_out[:, :9].reshape(n_point, 3, 3)
        b_l = ll_out[:, 9:12]
        h_oo = oo_out[:, :49].reshape(n_obj, 7, 7)
        b_o = oo_out[:, 49:56]
    w_pt = w_pt * plan.pt_pair_mask.to(dtype)[:, None, None]
    w_ob = w_ob * plan.ob_pair_mask.to(dtype)[:, None, None]
    rl_before, rl_after, rl_live, jb_rl, ja_rl = rl_rows
    h_pp = pp_out[:, :36].reshape(n_pose, 6, 6)
    h_pp_rel = pp_rel_out[:, :36].reshape(n_pose, 6, 6)
    b_p = pp_out[:, 36:42]

    def diag_add(h, vec):
        return h + torch.diag_embed(vec)

    h_pp = diag_add(h_pp, priors[0])
    h_ll = diag_add(h_ll, priors[1])
    h_oo = diag_add(h_oo, priors[2])
    b_p = b_p + priors[3]
    b_l = b_l + priors[4]
    b_o = b_o + priors[5]

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

    # ---- reduced camera system S -----------------------------------------
    pose_active = (_diag(h_pp).abs().sum(-1) > 1e-12) & free.poses
    act = pose_active.to(dtype)
    p_rng = torch.arange(n_pose, device=h_pp.device)
    # The scaled pair blocks W G (H^-1 = G G^T) enter S and, on the paths
    # without a slot tensor, the reduced RHS: the same rounded products on
    # both sides keep an f32 step as close to the f64 one as the slot path's.
    w_scaled = geo.bmm(w_pt, g_ll[plan.pt_pair_point.long()])  # (Np, 6, 3)
    w_ob_scaled = geo.bmm(w_ob, g_oo[plan.ob_pair_obj.long()])  # (No, 6, 7)
    z_pt = z_ob = band_deferred = None

    def rank_rows(n):
        """This rank's landmark rows of a gram (all of them without a mesh)."""
        return None if mesh is None else sharding.row_range(n, mesh)

    def cols(u, bw, rows):
        return u if rows is None else u[:, bw * rows[0]: bw * rows[1]]

    # Relpose cross blocks J_b^T J_a at (before, after); dead rows carry zero
    # Jacobians, so their clamped indices add exact zeros.
    rl_cross = _outer_rr(jb_rl, ja_rl)  # (R, 6, 6)
    bidx = rl_before.clamp(0, n_pose - 1)
    aidx = rl_after.clamp(0, n_pose - 1)
    if not paths.dense:
        diag_blocks = act[:, None, None] * h_pp_d + (1.0 - act)[:, None, None] * eye6
        s = _pair_enumeration_s(
            n_pose, diag_blocks, (rl_before, rl_after), rl_cross, plan, w_scaled, w_ob_scaled,
            mesh=mesh,
        )
    else:
        if not paths.pt_slot:
            u = _dense_from_pairs(
                plan.pt_pair_pose, plan.pt_pair_point, plan.pt_pair_mask, w_scaled, n_pose,
                n_point,
            )
            u = cols(u, 3, rank_rows(n_point))
            s_sub_pt = u @ u.T
        elif pt_band:
            s_sub_pt, z_pt = _band_slot_gram(
                w_scaled, plan.pt_slot_gather, plan.pt_slot_mask, band_local, n_pose, plain,
                emit_tiles=band_solve_on, rows=rank_rows(band_local.shape[1]),
            )
        else:
            s_sub_pt, z_pt = _slot_gram(
                w_scaled, plan.pt_slot_gather, plan.pt_slot_pose, plan.pt_slot_mask, n_pose,
                plain=plain, rows=rank_rows(plan.pt_slot_gather.shape[0]),
            )
        if paths.ob_slot:
            # The band solve's Woodbury term is all of z: no rows split.
            s_sub_ob, z_ob = _slot_gram(
                w_ob_scaled, plan.ob_slot_gather, plan.ob_slot_pose, plan.ob_slot_mask, n_pose,
                cp_order=cp_order, plain=plain, skip_gram=band_solve_on,
                rows=None if band_solve_on else rank_rows(plan.ob_slot_gather.shape[0]),
            )
        else:
            v_ob = _dense_from_pairs(
                plan.ob_pair_pose, plan.ob_pair_obj, plan.ob_pair_mask, w_ob_scaled, n_pose,
                n_obj, cp_order=cp_order,
            )
            v_ob = cols(v_ob, 7, rank_rows(n_obj))
            s_sub_ob = v_ob @ v_ob.T
        if mesh is not None:
            # The rank's partial grams -> the whole; z stays the rank's rows,
            # so the RHS and back-substitution take the pair forms below.
            if band_solve_on:
                s_sub_pt = tuple(_all_reduce_packed(s_sub_pt, mesh))
            else:
                s_sub_pt = _all_reduce_packed([s_sub_pt + s_sub_ob], mesh)[0]
                s_sub_ob = torch.zeros((), dtype=dtype, device=s_sub_pt.device)
            z_pt = None
        if cp_order:
            # c-major: the damped diagonal blocks and the relpose blocks at
            # (before, after) and their transposes go onto -(grams) directly.
            diag_blocks = act[:, None, None] * h_pp_d + (1.0 - act)[:, None, None] * eye6
            rows_blk = torch.cat([p_rng, bidx, aidx])
            cols_blk = torch.cat([p_rng, aidx, bidx])
            vals = torch.cat([diag_blocks, rl_cross, rl_cross.transpose(1, 2)])
            if band_solve_on:
                nb = n_pose // BAND_TP
                n_dom = _dd_domains(mesh, nb)
                if n_dom > 1 and n_dom == mesh.size:
                    # Deferred to the ranks' domains: the positive quadrants,
                    # and the blocks with their tiles (sentinel nb: no rank's).
                    t_r, t_c = rows_blk // BAND_TP, cols_blk // BAND_TP
                    band_deferred = (
                        torch.where(t_r == t_c, t_r, nb), torch.where(t_r == t_c + 1, t_c, nb),
                        rows_blk % BAND_TP, cols_blk % BAND_TP, vals)
                else:
                    d_tiles, e_tiles = _band_tiles(s_sub_pt, rows_blk, cols_blk, vals)
            else:
                ci = torch.arange(6, device=h_pp.device)
                rr = (ci[None, :, None] * n_pose + rows_blk[:, None, None]).expand(-1, 6, 6)
                cc = (ci[None, None, :] * n_pose + cols_blk[:, None, None]).expand(-1, 6, 6)
                s = (-(s_sub_pt + s_sub_ob)).index_put_((rr, cc), vals, accumulate=True)
        else:
            # Relpose blocks (diagonal + cross) and the damped pose diagonal,
            # minus its relpose part, as one gram V_rel V_rel^T: column block k
            # of V_rel holds J_b^T at row block before_k and J_a^T at after_k;
            # column block R + p holds the Cholesky factor of pose p's diagonal.
            diag_blocks = (
                act[:, None, None] * (h_pp_d - h_pp_rel) + (1.0 - act)[:, None, None] * eye6
            )
            l_diag = _cholesky_clamped(diag_blocks)
            n_rel = jb_rl.shape[0]
            k_rng = torch.arange(n_rel, device=h_pp.device)
            v_rel = _dense_from_pairs(
                torch.cat([rl_before, rl_after, p_rng]),
                torch.cat([k_rng, k_rng, n_rel + p_rng]),
                torch.cat([rl_live, rl_live, torch.ones_like(free.poses)]),
                torch.cat([jb_rl.transpose(1, 2), ja_rl.transpose(1, 2), l_diag]),
                n_pose,
                n_rel + n_pose,
            )
            s = v_rel @ v_rel.T - s_sub_pt - s_sub_ob
    # The band solve's Woodbury term; with a mesh the RHS and the
    # back-substitution read no slot tensor.
    z_ob_band = z_ob
    if mesh is not None:
        z_ob = None

    # ---- reduced RHS: b_S = b_p - sum W H^-1 b = b_p - (W G)(G^T b) ----
    # With a slot tensor z = W G live, one contraction; without it
    # (dense-from-pairs, pair enumeration), per pair row.
    def pair_rhs(b_s, wg, g, b, pair_land, pair_pose):
        g_pair = g[pair_land.long()]
        y = (g_pair * b[pair_land.long()][:, :, None]).sum(1)  # G^T b
        return b_s.index_add(0, pair_pose.long(), -geo.bmv(wg, y))

    b_s = b_p
    if z_pt is None:
        b_s = pair_rhs(b_s, w_scaled, g_ll, b_l, plan.pt_pair_point, plan.pt_pair_pose)
    else:
        g_ll_slot = g_ll[plan.pt_slot_land.long()]
        y_pt = (g_ll_slot * b_l[plan.pt_slot_land.long()][:, :, None]).sum(1)
        if pt_band:
            # Group g's (G, 768) contribution covers poses [64 g, 64 g + 128).
            n_group, k_rows, w_band = z_pt.shape
            width = band_gram.WIDTH
            contrib = torch.bmm(z_pt.transpose(1, 2), y_pt.reshape(n_group, k_rows, 1))
            contrib = contrib.reshape(n_group, 6, width).transpose(1, 2).reshape(
                n_group, w_band)
            flat = contrib.new_zeros(6 * BAND_TP * (n_group + 1))
            for g in range(n_group):
                flat[6 * BAND_TP * g: 6 * BAND_TP * g + w_band] += contrib[g]
            b_s = b_s - flat[: 6 * n_pose].reshape(n_pose, 6)
        else:
            b_s = b_s - (z_pt.T @ y_pt.reshape(-1)).reshape(n_pose, 6)
    if z_ob is None:
        b_s = pair_rhs(b_s, w_ob_scaled, g_oo, b_o, plan.ob_pair_obj, plan.ob_pair_pose)
    else:
        g_oo_slot = g_oo[plan.ob_slot_land.long()]
        y_ob = (g_oo_slot * b_o[plan.ob_slot_land.long()][:, :, None]).sum(1)
        contrib_ob = z_ob.T @ y_ob.reshape(-1)
        b_s = b_s - (contrib_ob.reshape(6, n_pose).T if cp_order else contrib_ob.reshape(n_pose, 6))
    b_s = b_s * act[:, None]

    # A failed factorization zeroes the step: model_cost_change is then 0 and
    # LM rejects it and shrinks the radius (Ceres' linear-solver failure).
    if band_solve_on:
        # rhs and Z permute into the tiles' (tile, component, local pose)
        # order; iterative refinement runs inside the band solve.
        rhs = b_s.T.reshape(6, nb, BAND_TP).transpose(0, 1).reshape(-1)
        z_band = z_ob_band.reshape(-1, 6, nb, BAND_TP).transpose(1, 2).reshape(
            z_ob_band.shape[0], -1)
        if band_deferred is not None:
            delta_band, ok = band_solve.dd_woodbury_band_solve(
                None, None, z_band, rhs, n_domains=n_dom, mesh=mesh,
                rel_scatter=band_deferred, gram_quads=s_sub_pt)
        elif n_dom > 1:
            delta_band, ok = band_solve.dd_woodbury_band_solve(
                d_tiles, e_tiles, z_band, rhs, n_domains=n_dom)
        else:
            delta_band, ok = band_solve.woodbury_band_solve(d_tiles, e_tiles, z_band, rhs)
        ok = ok & torch.isfinite(delta_band).all()
        delta_band = torch.where(ok, delta_band, torch.zeros_like(delta_band))
        delta_p = delta_band.reshape(nb, 6, BAND_TP).transpose(0, 1).reshape(6, n_pose).T
        delta_flat = delta_p.T.reshape(-1)
    else:
        # Cholesky + one step of iterative refinement. c-major S is a
        # symmetric permutation of the system: only the (P, 6) rhs and delta
        # are transposed at the boundary.
        rhs = b_s.T.reshape(-1) if cp_order else b_s.reshape(-1)
        chol, info = torch.linalg.cholesky_ex(s)
        delta_raw = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
        resid = rhs - s.T @ delta_raw
        delta_ref = delta_raw + torch.cholesky_solve(resid[:, None], chol)[:, 0]
        ok = (info == 0) & torch.isfinite(delta_ref).all()
        delta_flat = torch.where(ok, delta_ref, torch.zeros_like(delta_ref))
        delta_p = delta_flat.reshape(6, n_pose).T if cp_order else delta_flat.reshape(n_pose, 6)

    # ---- back-substitution: delta_x = H^-1 (b_x - W^T delta_p) ---------
    # With z live the coupling term is G (z^T delta_p) per landmark row.
    def back_substitute(h_inv, b, g_slot, q, slot_mask, slot_land, n_land):
        """q: (slot rows, d) = z^T delta_p per landmark row."""
        d = b.shape[-1]
        delta = geo.bmv(h_inv, b)
        corr = geo.bmv(g_slot, q)
        safe = torch.where(slot_mask.any(1), slot_land.long(), n_land)
        padded = torch.cat([delta, delta.new_zeros((1, d))])
        return padded.index_add_(0, safe, -corr)[:n_land]

    def pair_back_substitute(h_inv, b, w, pair_pose, pair_land, n_land):
        wt_dp = (w * delta_p[pair_pose.long()][:, :, None]).sum(1)
        return geo.bmv(h_inv, b - _segment_sum(wt_dp, pair_land, n_land))

    dp_vec = delta_flat if cp_order else delta_p.reshape(-1)
    if z_pt is None:
        delta_l = pair_back_substitute(
            h_ll_inv, b_l, w_pt, plan.pt_pair_pose, plan.pt_pair_point, n_point)
    else:
        if pt_band:
            # Group g reads the (c, p) window of poses [64 g, 64 g + 128).
            dp_pad = delta_p.new_zeros(6 * BAND_TP * (n_group + 1))
            dp_pad[: 6 * n_pose] = delta_p.reshape(-1)
            windows = dp_pad.unfold(0, w_band, 6 * BAND_TP)  # (G, 768) in (p, c)
            windows = windows.reshape(n_group, width, 6).transpose(1, 2).reshape(
                n_group, w_band)
            q_pt = torch.bmm(z_pt, windows[:, :, None]).reshape(-1, 3)
        else:
            q_pt = (z_pt @ dp_vec).reshape(-1, 3)
        delta_l = back_substitute(
            h_ll_inv, b_l, g_ll_slot, q_pt, plan.pt_slot_mask, plan.pt_slot_land, n_point
        )
    delta_l = delta_l * (~ll_singular)[:, None] * point_free[:, None]
    if z_ob is None:
        delta_o = pair_back_substitute(
            h_oo_inv, b_o, w_ob, plan.ob_pair_pose, plan.ob_pair_obj, n_obj)
    else:
        delta_o = back_substitute(
            h_oo_inv, b_o, g_oo_slot, (z_ob @ dp_vec).reshape(-1, 7), plan.ob_slot_mask,
            plan.ob_slot_land, n_obj,
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
    if mesh is not None:
        # Rank 0's step on every rank, bit for bit (replicated work on the
        # card need not round alike on every rank).
        flat = comm.broadcast(torch.cat([delta_p.reshape(-1), delta_l.reshape(-1),
                                         delta_o.reshape(-1), model_cost_change[None],
                                         grad_max[None]]), mesh)
        sizes = [delta_p.numel(), delta_l.numel(), delta_o.numel(), 1, 1]
        delta_p, delta_l, delta_o, model_cost_change, grad_max = torch.split(flat, sizes)
        delta_p, delta_l, delta_o = (delta_p.reshape(n_pose, 6), delta_l.reshape(n_point, 3),
                                     delta_o.reshape(n_obj, 7))
        model_cost_change, grad_max = model_cost_change[0], grad_max[0]
    return BAState(delta_p, delta_l, delta_o), model_cost_change, grad_max


def compute_marginal_covariances(
    state: BAState,
    cams,
    tables,
    plan,
    free,
    weights: FactorWeights,
    huber: HuberParams = HuberParams(),
    return_reduced_hessian: bool = False,
    ridge: float = 0.0,
    plain: bool = False,
):
    """Per-object marginal covariances at the current state (LTM extraction).

    Counterpart of ``obvi_slam_tpu/solver/schur.py::compute_marginal_
    covariances``: builds the undamped robustified Gauss-Newton Hessian (its
    residuals and Jacobians through K1 and K2, as ``compute_step``; their
    plain versions with ``plain``), eliminates the feature points (they
    couple to poses only), inverts the dense reduced (poses + objects)
    system and returns its 7x7 object diagonal blocks. Fixed and unobserved
    blocks are decoupled (zero cross terms, identity diagonal), so the rest
    equals the inverse with those parameters removed. ``ridge`` adds that
    much information to every active parameter.

    Returns (object covariances (K, 7, 7), h_diag {"pose", "point",
    "object"}: the Hessian's diagonals, ok) and, with
    ``return_reduced_hessian``, the reduced system. Nothing raises on a
    failed inverse: ``ok`` is False, and where the factorization failed
    (``inv_ex``'s info) the covariances are NaN."""
    dtype = state.poses.dtype
    device = state.poses.device
    n_pose, n_point, n_obj = (x.shape[0] for x in state)
    pose_free = free.poses.to(dtype)
    point_free = free.points.to(dtype)
    obj_free = free.objects.to(dtype)
    rp, bb, sh, rl, lt, pp = tables

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
    j_rp_pose = j_rp_pose * (w * pose_free[rp.pose_idx.long()])[:, None, None]
    j_rp_point = j_rp_point * (w * point_free[rp.point_idx.long()])[:, None, None]
    w = _block_weight(r_bb, huber.bbox, weights.bbox, bb.mask.to(dtype))
    j_bb_obj = j_bb_obj * (w * obj_free[bb.obj_idx.long()])[:, None, None]
    j_bb_pose = j_bb_pose * (w * pose_free[bb.pose_idx.long()])[:, None, None]
    r_sh, j_sh = fac.shape_residuals_and_jac(state, sh)
    w = _block_weight(r_sh, huber.shape, weights.shape, sh.mask.to(dtype))
    j_sh = j_sh * (w * obj_free[sh.obj_idx.long()])[:, None, None]
    r_rl, j_rl_b, j_rl_a = fac.relpose_residuals_and_jac(state, rl)
    w = _block_weight(r_rl, huber.relpose, weights.relpose, rl.mask.to(dtype))
    j_rl_b = j_rl_b * (w * pose_free[rl.before_idx.long()])[:, None, None]
    j_rl_a = j_rl_a * (w * pose_free[rl.after_idx.long()])[:, None, None]
    r_lt, j_lt = fac.ltm_residuals_and_jac(state, lt)
    w = _block_weight(r_lt, huber.ltm, weights.ltm, lt.mask.to(dtype))
    j_lt = j_lt * (w * obj_free[lt.obj_idx.long()])[:, None, None]

    # ---- block Hessians (undamped) ----------------------------------------
    def gram_sum(j, idx, n):
        return _segment_sum(_outer_rr(j, j), idx, n)

    h_ll = gram_sum(j_rp_point, rp.point_idx, n_point)
    h_oo = (
        gram_sum(j_bb_obj, bb.obj_idx, n_obj) + gram_sum(j_sh, sh.obj_idx, n_obj)
        + gram_sum(j_lt, lt.obj_idx, n_obj)
    )
    h_pp = (
        gram_sum(j_rp_pose, rp.pose_idx, n_pose) + gram_sum(j_bb_pose, bb.pose_idx, n_pose)
        + gram_sum(j_rl_b, rl.before_idx, n_pose) + gram_sum(j_rl_a, rl.after_idx, n_pose)
    )

    # Scalar parameter priors (the rank-deficiency repair) onto the diagonals.
    pp_w2 = pp.inv_std * pp.inv_std * pp.mask.to(dtype)
    bidx, pidx = pp.block_idx.long(), pp.param_idx.long()

    def prior_diag(kind, free_mask, n_block, dim):
        blk = bidx.clamp(0, n_block - 1)
        sel = (pp.block_kind == kind).to(dtype) * free_mask[blk]
        flat = blk * dim + pidx.clamp(0, dim - 1)
        vec = pp_w2.new_zeros(n_block * dim).index_add_(0, flat, pp_w2 * sel)
        return torch.diag_embed(vec.reshape(n_block, dim))

    h_pp = h_pp + prior_diag(0, pose_free, n_pose, 6)
    h_ll = h_ll + prior_diag(1, point_free, n_point, 3)
    h_oo = h_oo + prior_diag(2, obj_free, n_obj, 7)
    h_diag = {"pose": _diag(h_pp), "point": _diag(h_ll), "object": _diag(h_oo)}

    # ---- eliminate points --------------------------------------------------
    eye3 = torch.eye(3, dtype=dtype, device=device)
    ll_active = (_diag(h_ll).abs().sum(-1) > 1e-12) & free.points
    h_ll_inv = torch.linalg.inv_ex(torch.where(ll_active[:, None, None], h_ll, eye3))[0]
    h_ll_inv = h_ll_inv * ll_active[:, None, None].to(dtype)

    w_pt = _segment_sum(
        _outer_rr(j_rp_pose, j_rp_point), plan.rp_factor_pair, plan.pt_pair_pose.shape[0]
    ) * plan.pt_pair_mask[:, None, None].to(dtype)
    s_pp = h_pp.new_zeros((n_pose, n_pose, 6, 6))
    p_rng = torch.arange(n_pose, device=device)
    s_pp[p_rng, p_rng] += h_pp
    rl_cross = _outer_rr(j_rl_b, j_rl_a)
    bi, ai = rl.before_idx.long(), rl.after_idx.long()
    s_pp.index_put_((bi, ai), rl_cross, accumulate=True)
    s_pp.index_put_((ai, bi), rl_cross.transpose(1, 2), accumulate=True)
    dest_pt = _cross_blocks(w_pt, plan.pt_pair_point, plan.pt_cross_a, plan.pt_cross_b,
                            plan.pt_cross_mask, plan.pt_cross_dest, plan.pt_dest_mask,
                            h_inv=h_ll_inv)
    s_pp.index_put_((plan.pt_dest_a.long(), plan.pt_dest_b.long()), dest_pt, accumulate=True)

    # ---- pose-object coupling ----------------------------------------------
    w_ob = _segment_sum(
        _outer_rr(j_bb_pose, j_bb_obj), plan.bb_factor_pair, plan.ob_pair_pose.shape[0]
    ) * plan.ob_pair_mask[:, None, None].to(dtype)
    h_po = h_pp.new_zeros((n_pose, n_obj, 6, 7))
    h_po.index_put_((plan.ob_pair_pose.long(), plan.ob_pair_obj.long()), w_ob, accumulate=True)

    # ---- the dense reduced system ------------------------------------------
    np6, no7 = n_pose * 6, n_obj * 7
    a = h_pp.new_zeros((np6 + no7, np6 + no7))
    a[:np6, :np6] = s_pp.permute(0, 2, 1, 3).reshape(np6, np6)
    h_po_dense = h_po.permute(0, 2, 1, 3).reshape(np6, no7)
    a[:np6, np6:] = h_po_dense
    a[np6:, :np6] = h_po_dense.T
    o_rng = torch.arange(n_obj, device=device)
    oo_dense = h_oo.new_zeros((n_obj, n_obj, 7, 7))
    oo_dense[o_rng, o_rng] = h_oo
    a[np6:, np6:] = oo_dense.permute(0, 2, 1, 3).reshape(no7, no7)
    # Decouple fixed / inactive rows (identity diagonal); ``ridge`` adds
    # information to every active parameter.
    pose_active = (_diag(h_pp).abs().sum(-1) > 1e-12) & free.poses
    obj_active = (_diag(h_oo).abs().sum(-1) > 1e-12) & free.objects
    act = torch.cat(
        [pose_active.to(dtype).repeat_interleave(6), obj_active.to(dtype).repeat_interleave(7)]
    )
    a = a * act[:, None] * act[None, :]
    a = a + torch.diag(1.0 - act)
    a = a + torch.diag(act * ridge)

    sigma, info = torch.linalg.inv_ex(a)
    sigma = torch.where(info == 0, sigma, torch.full_like(sigma, float("nan")))
    ok = torch.isfinite(sigma).all()
    obj_covs = sigma[np6:, np6:].reshape(n_obj, 7, n_obj, 7)[o_rng, :, o_rng, :]
    if return_reduced_hessian:
        return obj_covs, h_diag, ok, a
    return obj_covs, h_diag, ok
