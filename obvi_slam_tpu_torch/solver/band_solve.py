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

The domain-decomposed (multi-device) solve of the reference is not ported.
"""

from __future__ import annotations

import torch

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


def cr_factor(d_tiles, e_tiles):
    """Block cyclic-reduction factorization of an SPD block-tridiagonal
    matrix: each level eliminates the odd-indexed blocks together (batched
    Cholesky and matmuls), halving the system, log2(nb) levels. Blocks are
    padded with identity diagonals and zero couplings to an even count per
    level (an uncoupled I x = 0 block). Returns (levels, root_chol, ok) for
    ``cr_solve``."""
    levels = []
    d, e = d_tiles, e_tiles
    ok = torch.ones((), dtype=torch.bool, device=d_tiles.device)
    while d.shape[0] > 1:
        nb, m, _ = d.shape
        if nb % 2 == 1:
            d = torch.cat([d, torch.eye(m, dtype=d.dtype, device=d.device)[None]])
            e = torch.cat([e, d.new_zeros((1, m, m))])
        # e has nb-1 live couplings; one zero pad so e_r[k] = e[2k+1] exists
        # for the last odd block.
        e_pad = torch.cat([e, d.new_zeros((1, m, m))])
        d_odd = d[1::2]  # blocks 2k+1
        e_l = e_pad[0::2]  # E_{2k}: couples even 2k -> odd 2k+1
        e_r = e_pad[1::2]  # E_{2k+1}: couples odd 2k+1 -> even 2k+2
        chol_odd, ok_l = _cholesky(d_odd)
        ok = ok & ok_l
        p_l = _chol_solve(chol_odd, e_l)  # D_odd^-1 E_{2k}
        p_r = _chol_solve(chol_odd, e_r.mT)  # D_odd^-1 E_{2k+1}^T
        term_r = e_l.mT @ p_l  # E_{2k}^T D^-1 E_{2k} at even 2k
        term_l = e_r @ p_r  # at even 2k+2
        d_new = d[0::2] - term_r
        d_new[1:] -= term_l[:-1]
        e_new = -(e_r @ p_l)[:-1]  # A'[k+1, k]
        levels.append((chol_odd, e_l, e_r))
        d, e = d_new, e_new
    root_chol, ok_root = _cholesky(d[0])
    return levels, root_chol, ok & ok_root


def cr_solve(factors, rhs):
    """Solve B x = rhs with ``cr_factor``'s output. ``rhs``: (nb, m, k)."""
    levels, root_chol, _ = factors
    stack = []
    b = rhs
    for chol_odd, e_l, e_r in levels:
        nb_orig, m, k = b.shape
        if nb_orig % 2 == 1:
            b = torch.cat([b, b.new_zeros((1, m, k))])
        b_odd = b[1::2]
        u = _chol_solve(chol_odd, b_odd)  # D_odd^-1 b_odd
        b_new = b[0::2] - e_l.mT @ u
        b_new[1:] -= e_r[:-1] @ u[:-1]
        stack.append((chol_odd, e_l, e_r, b_odd, b.shape[0], nb_orig))
        b = b_new
    x = _chol_solve(root_chol, b[0])[None]
    for chol_odd, e_l, e_r, b_odd, nb, nb_orig in reversed(stack):
        x_even = x  # (nb // 2, m, k)
        r = b_odd - e_l @ x_even
        # E_{2k+1}^T x_{2k+2}: even solutions shifted left; the last odd
        # block's right neighbour is the padding (zero).
        x_next = torch.cat([x_even[1:], torch.zeros_like(x_even[:1])])
        r = r - e_r.mT @ x_next
        x_odd = _chol_solve(chol_odd, r)
        x_full = x.new_empty((nb,) + tuple(x.shape[1:]))
        x_full[0::2] = x_even
        x_full[1::2] = x_odd
        x = x_full[:nb_orig]  # drop this level's even-pad block, if any
    return x


def block_tridiag_matvec(d_tiles, e_tiles, x):
    """B @ x for block-tridiagonal B, x: (nb, m, k)."""
    out = d_tiles @ x
    out[1:] += e_tiles @ x[:-1]  # block (i+1, i) x_i
    out[:-1] += e_tiles.mT @ x[1:]  # block (i, i+1) x_{i+1}
    return out


def _woodbury_from_bsolve(b_solve, d_tiles, e_tiles, z, rhs, n_refine):
    """Woodbury correction + iterative refinement given a B-solver
    ``b_solve``: (nb*m, k) -> (nb*m, k). Returns (x, ok) with ``ok`` the
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
