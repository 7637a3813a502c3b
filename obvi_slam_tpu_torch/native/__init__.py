"""The native host runtime: C++17 twins of two host hot paths, bound with
ctypes.

``schur_plan.cpp`` builds the pair plan of ``solver/plan.py::_build_pairs``
(unique (pose, landmark) pairs, per-landmark cross pairs, destination
dedup) and ``orb_loader.cpp`` parses the per-frame ORB observation files of
``io/readers.py::read_orb_output_directory``; both give their numpy or
pure-Python twin's outputs exactly. Copies of the JAX package's
``obvi_slam_tpu/native`` sources.

The library builds on first use with ``g++ -O3 -std=c++17 -shared -fPIC``
into ``native/build/`` (listed in .gitignore), under a name that carries a
hash of the sources and the flags, so an edited source is rebuilt and a
built one is reused. A failed build raises: the twins are reached only
through their callers' explicit ``native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = SRC / "build"
SOURCES = ("schur_plan.cpp", "orb_loader.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None


class _PairPlan(ctypes.Structure):
    _fields_ = [
        ("n_factors", ctypes.c_int64),
        ("n_pairs", ctypes.c_int64),
        ("n_cross", ctypes.c_int64),
        ("n_dest", ctypes.c_int64),
        ("factor_pair", ctypes.POINTER(ctypes.c_int32)),
        ("pair_block", ctypes.POINTER(ctypes.c_int32)),
        ("pair_land", ctypes.POINTER(ctypes.c_int32)),
        ("cross_a", ctypes.POINTER(ctypes.c_int32)),
        ("cross_b", ctypes.POINTER(ctypes.c_int32)),
        ("cross_dest", ctypes.POINTER(ctypes.c_int32)),
        ("dest_a", ctypes.POINTER(ctypes.c_int32)),
        ("dest_b", ctypes.POINTER(ctypes.c_int32)),
    ]


class _OrbObservations(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("feature_id", ctypes.POINTER(ctypes.c_int64)),
        ("frame_id", ctypes.POINTER(ctypes.c_int64)),
        ("camera_id", ctypes.POINTER(ctypes.c_int64)),
        ("px", ctypes.POINTER(ctypes.c_double)),
        ("py", ctypes.POINTER(ctypes.c_double)),
    ]


def cxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("native runtime: g++ not found on PATH")
    return found


def library_path() -> Path:
    src = b"".join((SRC / name).read_bytes() for name in SOURCES)
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libobvi_native-{digest}.so"


def build() -> str:
    """Compiles the library unless it is built; returns the compiler's output
    ("" when it was built already). Raises when the compiler fails."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx_path(), *CXX_FLAGS, "-o", str(tmp), *(str(SRC / n) for n in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime: {' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.build_pair_plan.restype = ctypes.c_int
    lib.build_pair_plan.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(_PairPlan),
    ]
    lib.free_pair_plan.argtypes = [ctypes.POINTER(_PairPlan)]
    lib.load_orb_observations.restype = ctypes.c_int
    lib.load_orb_observations.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(_OrbObservations),
    ]
    lib.free_orb_observations.argtypes = [ctypes.POINTER(_OrbObservations)]
    _lib = lib
    return lib


def _as_np(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def build_pair_plan(block_idx, land_idx, mask):
    """The pair plan's core: (factor_pair, pair_block, pair_land, cross_a,
    cross_b, cross_dest, dest_a, dest_b) as int32 numpy arrays, unpadded."""
    lib = load()
    block_idx = np.ascontiguousarray(block_idx, dtype=np.int64)
    land_idx = np.ascontiguousarray(land_idx, dtype=np.int64)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    plan = _PairPlan()
    rc = lib.build_pair_plan(
        block_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        land_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(block_idx),
        ctypes.byref(plan),
    )
    if rc != 0:
        raise RuntimeError(f"native runtime: build_pair_plan failed ({rc})")
    try:
        return (
            _as_np(plan.factor_pair, plan.n_factors, np.int32),
            _as_np(plan.pair_block, plan.n_pairs, np.int32),
            _as_np(plan.pair_land, plan.n_pairs, np.int32),
            _as_np(plan.cross_a, plan.n_cross, np.int32),
            _as_np(plan.cross_b, plan.n_cross, np.int32),
            _as_np(plan.cross_dest, plan.n_cross, np.int32),
            _as_np(plan.dest_a, plan.n_dest, np.int32),
            _as_np(plan.dest_b, plan.n_dest, np.int32),
        )
    finally:
        lib.free_pair_plan(ctypes.byref(plan))


def load_orb_observations(paths):
    """Per-frame ORB observation files -> (feature_id, frame_id, camera_id,
    px, py), one row per (feature, frame, camera) observation in file and
    line order."""
    lib = load()
    joined = b"\0".join(str(p).encode() for p in paths) + b"\0"
    obs = _OrbObservations()
    rc = lib.load_orb_observations(joined, len(paths), ctypes.byref(obs))
    if rc != 0:
        raise RuntimeError(f"native runtime: load_orb_observations failed ({rc})")
    try:
        return (
            _as_np(obs.feature_id, obs.n, np.int64),
            _as_np(obs.frame_id, obs.n, np.int64),
            _as_np(obs.camera_id, obs.n, np.int64),
            _as_np(obs.px, obs.n, np.float64),
            _as_np(obs.py, obs.n, np.float64),
        )
    finally:
        lib.free_orb_observations(ctypes.byref(obs))
