"""Tile-pair orders of the gram kernels K3 and K4 (``csrc/gram_common.cuh``).

The host-side twins of the kernels' pair arithmetic, for the numpy models of
their tile walks and chip_smoke.py's rows-per-tile counts.
"""

from __future__ import annotations


def lower_pair(t):
    """Lower pair index t -> (i, j), i >= j, row by row: the tile pairs of
    K4 and the panel pairs of K3 (gram_common.cuh::lower_pair)."""
    i = int(((8 * t + 1) ** 0.5 - 1) / 2)
    while i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


def diag_pair(t, n):
    """Pair rank t in diagonal-first order (i - j = 0, 1, ...) of the lower
    triangle of n x n tiles -> (i, j): K4's gram grid order
    (gram_common.cuh::diag_pair)."""
    d = 0
    while t >= n - d:
        t -= n - d
        d += 1
    return t + d, t
