"""Shared helpers of the tests that hold ``obvi_slam_tpu_torch`` against the
JAX reference package (f64 on CPU)."""

import numpy as np
import torch

from obvi_slam_tpu import types as jt
from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu.solver import two_phase as jtp
from obvi_slam_tpu.synthetic import synthetic_problem as jax_synthetic_problem
from obvi_slam_tpu_torch import convert

# Reference classes by name, for convert.to_numpy(types=...).
JAX_TYPES = {
    cls.__name__: cls
    for cls in (
        jt.BAState,
        jt.CameraBundle,
        jt.ReprojectionFactors,
        jt.BoundingBoxFactors,
        jt.ShapePriorFactors,
        jt.RelativePoseFactors,
        jt.LtmPriorFactors,
        jt.ParamPriorFactors,
        jt.FactorTables,
        jt.FreeMasks,
        jschur.SchurPlan,
        jschur.FactorWeights,
        jschur.HuberParams,
        jtp.TwoPhaseAux,
        jtp.TwoPhaseConfig,
    )
}


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_port(tree, dtype=None):
    return convert.to_torch(tree, device="cpu", dtype=dtype)


def jax_problem(n_poses, n_points, n_objects, **kw):
    return jax_synthetic_problem(
        n_poses=n_poses, n_points=n_points, n_objects=n_objects, **kw
    )


def rel_err(a, b):
    a = np.asarray(npy(a), dtype=np.float64).ravel()
    b = np.asarray(npy(b), dtype=np.float64).ravel()
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def assert_close(a, b, rtol, atol, err_msg=""):
    np.testing.assert_allclose(npy(a), npy(b), rtol=rtol, atol=atol, err_msg=err_msg)
