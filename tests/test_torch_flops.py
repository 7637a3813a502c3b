"""obvi_slam_tpu_torch.flops against obvi_slam_tpu.flops: the per-phase f32
FLOP model of one LM iteration, equal phase for phase on the same seeded
problems built by each package (dense plans and banded ones, with and
without the relative-pose band), and the speed-of-light table at the H100's
f32 peak."""

import numpy as np
import pytest

from obvi_slam_tpu import flops as jflops
from obvi_slam_tpu_torch import flops, synthetic_problem
from torch_port_helpers import jax_problem

SIZES = [
    dict(n_poses=8, n_points=64, n_objects=2),
    dict(n_poses=64, n_points=512, n_objects=8),
    dict(n_poses=256, n_points=512, n_objects=4, obs_per_point=6, obs_per_object=6),
    dict(n_poses=256, n_points=256, n_objects=4, obs_per_point=6, obs_per_object=6),
]


@pytest.mark.parametrize("size", SIZES, ids=["8", "64-dense", "256-banded", "256-banded-sparse"])
def test_flops_f32_equal_per_phase(size):
    ours = synthetic_problem(**size, device="cpu")
    ref = jax_problem(**size)
    banded = size["n_poses"] >= 256
    assert (ours[4].pt_band_local_pose is not None) == banded
    assert (ref[4].pt_band_local_pose is not None) == banded
    args = (size["n_poses"], size["n_points"], size["n_objects"])
    got = flops.lm_iteration_flops(ours[3], ours[4], *args)
    want = jflops.lm_iteration_flops(ref[3], ref[4], *args)
    assert list(got) == list(want)
    for phase, entry in want.items():
        assert got[phase] == {"flops_f32": entry["flops_f32"], "unit": entry["unit"]}, phase


def test_speed_of_light_table_at_the_f32_peak():
    tables, plan = synthetic_problem(n_poses=64, n_points=512, n_objects=8, device="cpu")[3:5]
    phases = flops.lm_iteration_flops(tables, plan, 64, 512, 8)
    total = sum(p["flops_f32"] for p in phases.values())
    table = flops.speed_of_light_table(phases, measured_iter_s=2e-3)
    assert table["peak_f32_flops"] == 67e12 and table["total_flops_f32"] == total
    for name, p in phases.items():
        assert table["phases"][name]["sol_us"] == p["flops_f32"] / 67e12 * 1e6
    np.testing.assert_allclose(table["sol_fraction"], total / 67e12 / 2e-3, rtol=1e-15)
    assert "sol_fraction" not in flops.speed_of_light_table(phases)
