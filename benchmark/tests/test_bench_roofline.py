"""The frozen operation and byte counts of K1-K4 against the kernel table's
bounds (PERF.md, measured on an H100 80GB HBM3 at 700 W)."""

import pytest

from benchmark import roofline


def test_k3_byte_bound_at_scale_1024():
    # scale_1024's K3 operands: 16 groups of 4224 z rows (1408 landmark
    # slots of 3 rows), 6 slots each, float32.
    n_bytes, flops = roofline.k3(16, 4224, 6, 4)
    least, by = roofline.bound_s(n_bytes, flops)
    assert by == "bytes"
    assert round(least * 1e3, 6) == 0.076633


def test_bounds_take_the_larger_side():
    assert roofline.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound_s(1.0, 67e12) == (1.0, "operations")


def test_k3_flops_count_live_slots():
    _, all_live = roofline.k3(1, 2, 6, 4)
    _, counted = roofline.k3(1, 2, 6, 4, live_slots=[6, 6])
    assert all_live == counted == 2 * 36 * 37
    assert roofline.k3(1, 2, 6, 4, live_slots=[1, 0])[1] == 6 * 7


@pytest.mark.parametrize("fn, args", [(roofline.k1, (10, 4, 5, 2, 4, 10)),
                                      (roofline.k2, (10, 3, 4, 2, 4, 10)),
                                      (roofline.k4, (100, 8, 4))])
def test_counts_grow_with_rows(fn, args):
    small = fn(*args)
    big = fn(*((2 * args[0],) + args[1:]))
    assert big[0] > small[0] and big[1] >= small[1] > 0
