"""Carry problem state between the JAX package's pytrees and this port.

``to_torch`` takes any of the reference's NamedTuples (``BAState``,
``CameraBundle``, the factor tables, ``FactorTables``, ``SchurPlan``,
``FreeMasks``, ``FactorWeights``, ``HuberParams``, ``TwoPhaseAux``,
``TwoPhaseConfig``) with array leaves that numpy can read, and returns the
port's NamedTuple of the same name with tensors on ``device``. Floating
leaves are cast to ``dtype`` (a numpy or torch float type) when it is given;
index (int32) and mask (bool) leaves keep their type. Python scalars pass
through. ``to_numpy`` is the converse, for tests: it returns
numpy leaves in the port's classes, or in the classes of ``types`` (a
mapping from class name to class) when given. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from obvi_slam_tpu_torch import types as T
from obvi_slam_tpu_torch.solver.plan import SchurPlan
from obvi_slam_tpu_torch.solver.schur import FactorWeights, HuberParams
from obvi_slam_tpu_torch.solver.two_phase import TwoPhaseAux, TwoPhaseConfig

PORT_TYPES = {
    cls.__name__: cls
    for cls in (
        T.BAState,
        T.CameraBundle,
        T.ReprojectionFactors,
        T.BoundingBoxFactors,
        T.ShapePriorFactors,
        T.RelativePoseFactors,
        T.LtmPriorFactors,
        T.ParamPriorFactors,
        T.FactorTables,
        T.FreeMasks,
        SchurPlan,
        FactorWeights,
        HuberParams,
        TwoPhaseAux,
        TwoPhaseConfig,
    )
}

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cuda", dtype=None):
    """Reference NamedTuple (or nested ones) -> the port's, on ``device``."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if _is_namedtuple(tree):
        cls = PORT_TYPES[type(tree).__name__]
        return cls(**{k: to_torch(v, device, dtype) for k, v in tree._asdict().items()})
    arr = np.array(tree)  # a writable copy
    t = torch.from_numpy(arr)
    if dtype is not None and arr.dtype.kind == "f":
        t = t.to(dtype if isinstance(dtype, torch.dtype) else _TORCH_DTYPES[np.dtype(dtype)])
    return t.to(device)


def to_numpy(tree, types=None):
    """The port's NamedTuple -> numpy leaves, in ``types[name]`` classes when
    ``types`` is given (e.g. the reference's), else in the port's."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if _is_namedtuple(tree):
        name = type(tree).__name__
        cls = (types or PORT_TYPES)[name]
        return cls(**{k: to_numpy(v, types) for k, v in tree._asdict().items()})
    return tree.detach().cpu().numpy()
