"""Block-tridiagonal + low-rank (Woodbury) reduced-camera solve.

Counterpart of ``obvi_slam_tpu/solver/band_solve.py`` (its single-device
half). At ~10^3 poses the dense reduced system S is (6P)^2 and its Cholesky
O(P^3); under the banded layout S splits as

  S = B - Z^T Z,

B block-tridiagonal at 64-pose tiles of m = 384 rows (feature tracks span at
most two consecutive tiles, odometry links consecutive poses) and Z the
object coupling, of rank <= 7K for K objects. The solve is a
block-tridiagonal Cholesky (sequential over the nb tiles, or cyclic reduction
from ``_BAND_CR_MIN_NB`` tiles: log2(nb) batched levels) plus the Woodbury
correction

  S^-1 r = B^-1 r + Y C^-1 Z (B^-1 r),   Y = B^-1 Z^T,  C = I - Z Y,

with ``n_refine`` steps of iterative refinement. Tiles are in the banded
path's c-major-within-tile order ((component, local pose) flattening), so no
S-sized buffer is ever allocated.

Every factorization goes through ``torch.linalg.cholesky_ex``, which reads
the lower triangle and reports failure in ``info`` instead of raising (its
factor may then be finite garbage): each function that factors returns an
``ok`` flag (a 0-dim bool tensor on the device, no host sync) that is False
when any factorization failed. Callers zero the step when it is False or the
result is not finite.

``dd_woodbury_band_solve`` is the reference's trajectory-domain
decomposition: B split into h contiguous runs of nb / h tiles, each run's
first tile an interface and the rest its interior. Interiors factor and
solve by cyclic reduction batched over the domains; the interface Schur
complement is a small block-tridiagonal system over the h interface tiles.
With a mesh of h ranks it runs one domain per rank (``_dd_rank_solve``), with
every collective written out through ``parallel.comm``.
"""

from __future__ import annotations

import torch

from obvi_slam_tpu_torch.parallel import comm

# Cyclic-reduction gate: "auto" switches to CR from _BAND_CR_MIN_NB tiles;
# "on" / "off" force it (tests set these with monkeypatch). compute_step's
# auto band gate engages from 512 poses (8 tiles of 64), so the sequential
# loop runs where a caller forces the band solve on below that.
_BAND_CR = "auto"
_BAND_CR_MIN_NB = 8


def _use_cyclic_reduction(nb: int) -> bool:
    if _BAND_CR == "off":
        return False
    if _BAND_CR == "on":
        return True
    return nb >= _BAND_CR_MIN_NB


def _cholesky(a):
    """Lower Cholesky factor of ``a`` (batched) and a 0-dim ``ok`` flag."""
    low, info = torch.linalg.cholesky_ex(a)
    return low, (info == 0).all()


def _tri_solve(low, b, trans=False):
    """Solve L x = b, or L^T x = b with ``trans``; b has a trailing column dim."""
    if trans:
        return torch.linalg.solve_triangular(low.mT, b, upper=True)
    return torch.linalg.solve_triangular(low, b, upper=False)


def block_tridiag_cholesky(d_tiles, e_tiles):
    """Cholesky of a symmetric PD block-tridiagonal matrix.

    ``d_tiles``: (nb, m, m) diagonal blocks; ``e_tiles``: (nb-1, m, m)
    sub-diagonal blocks, e_tiles[i] = B[i+1, i]. Returns (l_d, l_e, ok):
    l_d[i] lower-triangular with L[i, i] = l_d[i], L[i+1, i] = l_e[i].

      A_0 = D_0;  A_{i+1} = D_{i+1} - L_{i+1,i} L_{i+1,i}^T
      L_ii = chol(A_i);  L_{i+1,i} = E_i L_ii^{-T}
    """
    nb = d_tiles.shape[0]
    contrib = torch.zeros_like(d_tiles[0])
    ok = torch.ones((), dtype=torch.bool, device=d_tiles.device)
    l_d, l_e = [], []
    for i in range(nb):
        l_ii, ok_i = _cholesky(d_tiles[i] - contrib)
        ok = ok & ok_i
        l_d.append(l_ii)
        if i + 1 < nb:
            # L_{i+1,i} = E_i L_ii^{-T}  <=>  solve L_ii X^T = E_i^T.
            l_next = _tri_solve(l_ii, e_tiles[i].mT).mT
            contrib = l_next @ l_next.mT
            l_e.append(l_next)
    l_e = torch.stack(l_e) if l_e else d_tiles.new_zeros((0,) + tuple(d_tiles.shape[1:]))
    return torch.stack(l_d), l_e, ok


def block_tridiag_solve(l_d, l_e, rhs):
    """Solve B x = rhs given the block-tridiagonal Cholesky factors.

    ``rhs``: (nb, m, k). Forward then backward block substitution."""
    nb = l_d.shape[0]
    y = []
    for i in range(nb):
        r = rhs[i] if i == 0 else rhs[i] - l_e[i - 1] @ y[i - 1]
        y.append(_tri_solve(l_d[i], r))
    x = [None] * nb
    for i in reversed(range(nb)):
        r = y[i] if i == nb - 1 else y[i] - l_e[i].mT @ x[i + 1]
        x[i] = _tri_solve(l_d[i], r, trans=True)
    return torch.stack(x)


def _chol_solve(chol, b):
    """Batched SPD solve from a (batched) Cholesky factor."""
    return _tri_solve(chol, _tri_solve(chol, b), trans=True)


def _cat_tiles(*parts):
    return torch.cat(parts, dim=-3)


def cr_factor(d_tiles, e_tiles):
    """Block cyclic-reduction factorization of an SPD block-tridiagonal
    matrix: each level eliminates the odd-indexed blocks together (batched
    Cholesky and matmuls), halving the system, log2(nb) levels. Blocks are
    padded with identity diagonals and zero couplings to an even count per
    level (an uncoupled I x = 0 block). The tiles are the last three axes:
    leading axes batch independent systems (the domain-decomposed solve's
    interiors). Returns (levels, root_chol, ok) for ``cr_solve``."""
    levels = []
    d, e = d_tiles, e_tiles
    ok = torch.ones((), dtype=torch.bool, device=d_tiles.device)
    while d.shape[-3] > 1:
        nb, m = d.shape[-3], d.shape[-1]
        zero = d.new_zeros(d.shape[:-3] + (1, m, m))
        if nb % 2 == 1:
            eye = torch.eye(m, dtype=d.dtype, device=d.device).expand_as(zero)
            d = _cat_tiles(d, eye)
            e = _cat_tiles(e, zero)
        # e has nb-1 live couplings; one zero pad so e_r[k] = e[2k+1] exists
        # for the last odd block.
        e_pad = _cat_tiles(e, zero)
        d_odd = d[..., 1::2, :, :]  # blocks 2k+1
        e_l = e_pad[..., 0::2, :, :]  # E_{2k}: couples even 2k -> odd 2k+1
        e_r = e_pad[..., 1::2, :, :]  # E_{2k+1}: couples odd 2k+1 -> even 2k+2
        chol_odd, ok_l = _cholesky(d_odd)
        ok = ok & ok_l
        p_l = _chol_solve(chol_odd, e_l)  # D_odd^-1 E_{2k}
        p_r = _chol_solve(chol_odd, e_r.mT)  # D_odd^-1 E_{2k+1}^T
        term_r = e_l.mT @ p_l  # E_{2k}^T D^-1 E_{2k} at even 2k
        term_l = e_r @ p_r  # at even 2k+2
        d_new = d[..., 0::2, :, :] - term_r
        d_new[..., 1:, :, :] -= term_l[..., :-1, :, :]
        e_new = -(e_r @ p_l)[..., :-1, :, :]  # A'[k+1, k]
        levels.append((chol_odd, e_l, e_r))
        d, e = d_new, e_new
    root_chol, ok_root = _cholesky(d[..., 0, :, :])
    return levels, root_chol, ok & ok_root


def cr_solve(factors, rhs):
    """Solve B x = rhs with ``cr_factor``'s output. ``rhs``: (..., nb, m,
    k), with the factorization's leading axes."""
    levels, root_chol, _ = factors
    stack = []
    b = rhs
    for chol_odd, e_l, e_r in levels:
        nb_orig, m, k = b.shape[-3:]
        if nb_orig % 2 == 1:
            b = _cat_tiles(b, b.new_zeros(b.shape[:-3] + (1, m, k)))
        b_odd = b[..., 1::2, :, :]
        u = _chol_solve(chol_odd, b_odd)  # D_odd^-1 b_odd
        b_new = b[..., 0::2, :, :] - e_l.mT @ u
        b_new[..., 1:, :, :] -= e_r[..., :-1, :, :] @ u[..., :-1, :, :]
        stack.append((chol_odd, e_l, e_r, b_odd, b.shape[-3], nb_orig))
        b = b_new
    x = _chol_solve(root_chol, b[..., 0, :, :])[..., None, :, :]
    for chol_odd, e_l, e_r, b_odd, nb, nb_orig in reversed(stack):
        x_even = x  # (..., nb // 2, m, k)
        r = b_odd - e_l @ x_even
        # E_{2k+1}^T x_{2k+2}: even solutions shifted left; the last odd
        # block's right neighbour is the padding (zero).
        x_next = _cat_tiles(x_even[..., 1:, :, :], torch.zeros_like(x_even[..., :1, :, :]))
        r = r - e_r.mT @ x_next
        x_odd = _chol_solve(chol_odd, r)
        x_full = x.new_empty(x.shape[:-3] + (nb,) + tuple(x.shape[-2:]))
        x_full[..., 0::2, :, :] = x_even
        x_full[..., 1::2, :, :] = x_odd
        x = x_full[..., :nb_orig, :, :]  # drop this level's even-pad block, if any
    return x


def block_tridiag_matvec(d_tiles, e_tiles, x):
    """B @ x for block-tridiagonal B, x: (nb, m, k)."""
    out = d_tiles @ x
    out[1:] += e_tiles @ x[:-1]  # block (i+1, i) x_i
    out[:-1] += e_tiles.mT @ x[1:]  # block (i, i+1) x_{i+1}
    return out


def _woodbury_from_bsolve(b_solve, d_tiles, e_tiles, z, rhs, n_refine, matvec=None):
    """Woodbury correction + iterative refinement given a B-solver
    ``b_solve``: (nb*m, k) -> (nb*m, k); ``matvec`` replaces the refinement's
    B x (the domain-decomposed solve's). Returns (x, ok) with ``ok`` the
    success of the factorization of C."""
    nb, m, _ = d_tiles.shape
    rz = z.shape[0]
    # One band traversal for rhs and Z^T together.
    y_all = b_solve(torch.cat([rhs[:, None], z.T], dim=1))
    x0_first = y_all[:, 0]
    y = y_all[:, 1:]  # (nb*m, rz) = B^-1 Z^T
    c = torch.eye(rz, dtype=d_tiles.dtype, device=d_tiles.device) - z @ y
    l_c, ok = _cholesky(0.5 * (c + c.T))

    def s_correct(x0):
        t = _chol_solve(l_c, (z @ x0)[:, None])[:, 0]
        return x0 + y @ t

    def s_solve(r_flat):
        return s_correct(b_solve(r_flat[:, None])[:, 0])

    def s_matvec(x):
        if matvec is not None:
            bx = matvec(x)
        else:
            bx = block_tridiag_matvec(d_tiles, e_tiles, x.reshape(nb, m, 1)).reshape(nb * m)
        return bx - z.T @ (z @ x)

    x = s_correct(x0_first)
    for _ in range(n_refine):
        x = x + s_solve(rhs - s_matvec(x))
    return x, ok


def woodbury_band_solve(d_tiles, e_tiles, z, rhs, n_refine=1):
    """Solve (B - Z^T Z) x = rhs with B block-tridiagonal PD.

    ``z``: (rz, nb*m) low-rank factor rows in the same flattened tile order
    as ``rhs`` (nb*m,). Returns (x, ok): the solution flattened to (nb*m,)
    and a 0-dim bool tensor, False when a factorization failed."""
    nb, m, _ = d_tiles.shape
    if _use_cyclic_reduction(nb):
        cr = cr_factor(d_tiles, e_tiles)
        ok_b = cr[2]

        def b_solve(v):
            return cr_solve(cr, v.reshape(nb, m, -1)).reshape(nb * m, -1)

    else:
        l_d, l_e, ok_b = block_tridiag_cholesky(d_tiles, e_tiles)

        def b_solve(v):
            return block_tridiag_solve(l_d, l_e, v.reshape(nb, m, -1)).reshape(nb * m, -1)

    x, ok_c = _woodbury_from_bsolve(b_solve, d_tiles, e_tiles, z, rhs, n_refine)
    return x, ok_b & ok_c


def _dd_domains_batched(d_tiles, e_tiles, z, rhs, h, n_refine):
    """The domain-decomposed solve on one process: the interiors batched over
    a leading domain axis (the reference's ``vmap`` over domains)."""
    nb, m, _ = d_tiles.shape
    nb_l = nb // h
    d_dom = d_tiles.reshape(h, nb_l, m, m)
    # e_dom[d, j] = B[tile d nb_l + j + 1, tile d nb_l + j]: j = 0 interface
    # -> first interior tile, then the interior's couplings, j = nb_l - 1 the
    # interior's last tile -> the next interface (a zero pad on the last).
    e_dom = torch.cat([e_tiles, e_tiles.new_zeros((1, m, m))]).reshape(h, nb_l, m, m)
    d_if = d_dom[:, 0]
    e_first, e_last = e_dom[:, 0], e_dom[:, nb_l - 1]
    fac = cr_factor(d_dom[:, 1:], e_dom[:, 1: nb_l - 1])

    # Interface-column solves: the B_IG columns of each domain's two
    # neighbouring interfaces.
    ef_rhs = d_tiles.new_zeros((h, nb_l - 1, m, m))
    ef_rhs[:, 0] = e_first
    el_rhs = torch.zeros_like(ef_rhs)
    el_rhs[:, -1] = e_last.mT
    y_fl = cr_solve(fac, torch.cat([ef_rhs, el_rhs], dim=-1))
    yf, yl = y_fl[..., :m], y_fl[..., m:]

    # Interface Schur complement, block-tridiagonal over the h interfaces.
    sg_d = d_if - e_first.mT @ yf[:, 0]
    sg_d[1:] -= (e_last @ yl[:, -1])[:-1]
    sg_e = -(e_last @ yf[:, -1])[: h - 1]
    l_sd, l_se, ok_s = block_tridiag_cholesky(sg_d, sg_e)

    def b_solve(v_flat):
        k = v_flat.shape[-1]
        vd = v_flat.reshape(h, nb_l, m, k)
        u = cr_solve(fac, vd[:, 1:])  # (h, nb_l - 1, m, k)
        r_g = vd[:, 0] - e_first.mT @ u[:, 0]
        r_g[1:] -= e_last[:-1] @ u[:-1, -1]
        g = block_tridiag_solve(l_sd, l_se, r_g)  # (h, m, k)
        g_next = torch.cat([g[1:], torch.zeros_like(g[:1])])
        x_int = u - yf @ g[:, None] - yl @ g_next[:, None]
        return torch.cat([g[:, None], x_int], dim=1).reshape(nb * m, k)

    def dd_matvec(x_flat):
        """B x in the domain layout: the cross-domain couplings touch each
        domain's boundary tiles only."""
        xd = x_flat.reshape(h, nb_l, m, 1)
        out = d_dom @ xd
        e_in = e_dom[:, : nb_l - 1]
        out[:, 1:] += e_in @ xd[:, : nb_l - 1]
        out[:, : nb_l - 1] += e_in.mT @ xd[:, 1:]
        out[1:, 0] += e_dom[:-1, -1] @ xd[:-1, -1]
        out[:-1, -1] += e_dom[:-1, -1].mT @ xd[1:, 0]
        return out.reshape(nb * m)

    x, ok_c = _woodbury_from_bsolve(b_solve, d_tiles, e_tiles, z, rhs, n_refine,
                                    matvec=dd_matvec)
    return x, fac[2] & ok_s & ok_c


def _from_previous(x, mesh):
    """The previous rank's block ``x``, zeros on rank 0 (the reference's
    forward ppermute, as an all_gather of the boundary block)."""
    blocks = comm.all_gather(x, mesh)
    return blocks[mesh.rank - 1] if mesh.rank > 0 else torch.zeros_like(x)


def _dd_rank_solve(tiles, z_loc, r_loc, mesh, n_refine, rel_scatter=None, tp=None):
    """One domain per rank (the reference's ``_dd_shard_map_solve`` body).

    ``tiles``: this rank's (d, e) tiles, (nb_l, m, m) each, e[j] = B[tile
    j + 1, tile j] of the domain (the last rank's last one zero); or, with
    ``rel_scatter``, its gram quadrants (q00, q10, q11), (nb_l, m, m) each,
    positive and unfolded: the overlap fold (one cross-domain term), the
    negation and the relpose and diagonal updates (d_dest, e_dest, pl_r,
    pl_c, vals; replicated, in the global tile numbering, ``tp`` poses per
    tile) that land in this rank's tile range happen here. ``z_loc`` (rz,
    nb_l m) and ``r_loc`` (nb_l m,) are this domain's columns of Z and rows
    of the rhs. Returns (x_loc, ok), ``ok`` reduced over the ranks."""
    h, idx = mesh.size, mesh.rank
    is_last = idx == h - 1
    if rel_scatter is not None:
        q00, q10, q11 = tiles
        nb_l, m, _ = q00.shape
        d_loc = q00.clone()
        d_loc[1:] += q11[:-1]
        d_loc[0] += _from_previous(q11[-1], mesh)
        e_loc = q10.clone()
        if is_last:
            e_loc[-1] = 0.0  # the global pad group's coupling
        d_dest, e_dest, pl_r, pl_c, vals = rel_scatter
        base = idx * nb_l
        ci = torch.arange(6, device=vals.device)

        def ix(dest):
            # Updates of other ranks' tiles go to a spare tile past the end.
            loc = dest - base
            loc = torch.where((loc >= 0) & (loc < nb_l), loc, nb_l)
            return (loc[:, None, None], ci[None, :, None], pl_r[:, None, None],
                    ci[None, None, :], pl_c[:, None, None])

        def updated(t, dest):
            t5 = torch.cat([-t, torch.zeros_like(t[:1])]).reshape(nb_l + 1, 6, tp, 6, tp)
            t5.index_put_(ix(dest), vals, accumulate=True)
            return t5[:nb_l].reshape(nb_l, m, m)

        d_loc, e_loc = updated(d_loc, d_dest), updated(e_loc, e_dest)
    else:
        d_loc, e_loc = tiles
        nb_l, m, _ = d_loc.shape
    rz = z_loc.shape[0]
    ell = nb_l * m

    d_if = d_loc[0]
    e_first, e_last = e_loc[0], e_loc[nb_l - 1]
    fac = cr_factor(d_loc[1:], e_loc[1: nb_l - 1])
    ef_rhs = d_loc.new_zeros((nb_l - 1, m, m))
    ef_rhs[0] = e_first
    el_rhs = torch.zeros_like(ef_rhs)
    el_rhs[-1] = e_last.T
    y_fl = cr_solve(fac, torch.cat([ef_rhs, el_rhs], dim=-1))
    yf, yl = y_fl[..., :m], y_fl[..., m:]
    # Each rank combines its own interface diagonal (the previous domain's
    # term arrives as one halo block), so the interface system costs two
    # (h, m, m) gathers.
    sg_own = d_if - e_first.T @ yf[0] - _from_previous(e_last @ yl[-1], mesh)
    sg_d = comm.all_gather(sg_own, mesh)
    sg_e = -comm.all_gather(e_last @ yf[-1], mesh)[: h - 1]
    l_sd, l_se, ok_s = block_tridiag_cholesky(sg_d, sg_e)

    def b_solve_loc(v_tiles):  # (nb_l, m, k) -> (nb_l, m, k)
        u = cr_solve(fac, v_tiles[1:])
        rg = v_tiles[0] - e_first.T @ u[0] - _from_previous(e_last @ u[-1], mesh)
        g = block_tridiag_solve(l_sd, l_se, comm.all_gather(rg, mesh))  # (h, m, k)
        g_own = g[idx]
        g_next = torch.zeros_like(g_own) if is_last else g[idx + 1]
        x_int = u - yf @ g_own - yl @ g_next
        return torch.cat([g_own[None], x_int])

    v = torch.cat([r_loc[:, None], z_loc.T], dim=1)
    y_all = b_solve_loc(v.reshape(nb_l, m, 1 + rz))
    x0 = y_all[..., 0].reshape(ell)
    y_loc = y_all[..., 1:].reshape(ell, rz)
    c = torch.eye(rz, dtype=z_loc.dtype, device=z_loc.device) - comm.all_reduce(
        z_loc @ y_loc, mesh)
    l_c, ok_c = _cholesky(0.5 * (c + c.T))

    def s_correct(x):
        w = comm.all_reduce(z_loc @ x, mesh)
        return x + y_loc @ _chol_solve(l_c, w[:, None])[:, 0]

    def s_matvec(x):
        """Domain-local B x - Z^T Z x; the couplings across the domain
        boundaries come from the neighbours as halo blocks."""
        xt = x.reshape(nb_l, m, 1)
        out = d_loc @ xt
        e_in = e_loc[: nb_l - 1]
        out[1:] += e_in @ xt[:-1]
        out[:-1] += e_in.mT @ xt[1:]
        halos = comm.all_gather(torch.stack([e_last @ xt[-1], xt[0]]), mesh)
        if idx > 0:
            out[0] += halos[idx - 1, 0]
        if not is_last:
            out[-1] += e_last.T @ halos[idx + 1, 1]
        zx = comm.all_reduce(z_loc @ x, mesh)
        return out.reshape(ell) - z_loc.T @ zx

    x = s_correct(x0)
    for _ in range(n_refine):
        r = r_loc - s_matvec(x)
        x = x + s_correct(b_solve_loc(r.reshape(nb_l, m, 1))[..., 0].reshape(ell))
    ok = fac[2] & ok_s & ok_c
    ok = comm.all_reduce(ok.to(torch.int32), mesh, op="min") > 0
    return x, ok


def dd_woodbury_band_solve(
    d_tiles, e_tiles, z, rhs, n_domains, n_refine=1, mesh=None, rel_scatter=None,
    gram_quads=None,
):
    """Solve (B - Z^T Z) x = rhs, as ``woodbury_band_solve``, with B split
    into ``n_domains`` contiguous runs of nb / n_domains tiles.

    With a ``mesh`` of exactly ``n_domains`` ranks each rank solves its own
    domain (``_dd_rank_solve``); the arguments are the whole system, as every
    rank holds it, and so is the result. Only there may the tiles come
    deferred: ``gram_quads`` (q00, q10, q11), each (nb, 6, tp, 6, tp), with
    ``rel_scatter`` (d_dest, e_dest, pl_r, pl_c, vals), d_tiles and e_tiles
    None (see ``_dd_rank_solve``). Otherwise the interiors are batched over
    the domains on this process. Returns (x, ok)."""
    nb = (gram_quads[0] if gram_quads is not None else d_tiles).shape[0]
    h = int(n_domains)
    if nb % h != 0 or nb // h < 2:
        raise ValueError(f"n_domains={h} needs nb % h == 0 and >=2 tiles/domain (nb={nb})")
    if mesh is not None and h > 1 and h == mesh.size:
        if (gram_quads is not None) != (rel_scatter is not None):
            # The gram's negation happens with the updates: one without the
            # other would solve a system of the wrong sign.
            raise ValueError("gram_quads and rel_scatter must be passed together")
        nb_l = nb // h
        base = mesh.rank * nb_l
        own = slice(base, base + nb_l)
        if gram_quads is not None:
            tp = gram_quads[0].shape[2]
            m = 6 * tp
            tiles = tuple(q[own].reshape(nb_l, m, m) for q in gram_quads)
        else:
            tp = None
            m = d_tiles.shape[1]
            e_pad = torch.cat([e_tiles, e_tiles.new_zeros((1, m, m))])
            tiles = (d_tiles[own], e_pad[own])
        cols = slice(base * m, (base + nb_l) * m)
        x_loc, ok = _dd_rank_solve(tiles, z[:, cols], rhs[cols], mesh, n_refine,
                                   rel_scatter=rel_scatter, tp=tp)
        return comm.all_gather(x_loc, mesh).reshape(nb * m), ok
    if rel_scatter is not None or gram_quads is not None:
        raise ValueError("deferred tile updates / gram quadrants need one domain per rank: "
                         "n_domains must equal the mesh size")
    return _dd_domains_batched(d_tiles, e_tiles, z, rhs, h, n_refine)
