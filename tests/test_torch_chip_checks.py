"""The f32 check chip_smoke.py holds K2 to at the object session's tables
(``_compare_f32_rounding``), run on the CPU with the plain version standing
in for the kernel: it passes the plain f32 version's own output and fails an
output with one Jacobian column perturbed by 1e-3 of the output's largest
entry, in every column of both Jacobians."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch.synthetic import synthetic_problem

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module")
def bbox_outputs():
    """(f32 plain output, f64 plain output on the same values, live mask) at
    a small synthetic problem's bounding-box table."""
    state, _, cams, tables, *_ = synthetic_problem(
        n_poses=6, n_points=32, n_objects=4, obs_per_point=3, obs_per_object=6, seed=3,
        dtype=np.float32, device="cpu")
    bb = tables.bbox
    f32 = fac.bbox_residuals_and_jac(state, cams, bb)
    f64 = fac.bbox_residuals_and_jac(*(chip_smoke._cast(x, torch.float64)
                                       for x in (state, cams, bb)))
    return f32, f64, bb.mask


def test_plain_output_passes(bbox_outputs):
    f32, f64, live = bbox_outputs
    worst = chip_smoke._compare_f32_rounding("bbox", f32, f32, f64, live)
    assert worst["err"] == 0.0 and worst["ratio"] == 0.0
    assert 0.0 < worst["plain_err"] < worst["floor"]


@pytest.mark.parametrize("output,column", [(1, c) for c in range(7)] + [(2, c) for c in range(6)])
def test_perturbed_jacobian_column_fails(bbox_outputs, output, column):
    f32, f64, live = bbox_outputs
    bad = [t.clone() for t in f32]
    bad[output][live, :, column] += 1e-3 * float(f32[output].abs().max())
    with pytest.raises(AssertionError, match=f"output {output} row"):
        chip_smoke._compare_f32_rounding("bbox", bad, f32, f64, live)
