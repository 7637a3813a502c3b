"""The port's native host runtime (``obvi_slam_tpu_torch/native``, built
with g++ on first use) against its twins: the pair plan array for array
equal to the numpy twin (``plan._pair_plan_numpy``) and to the JAX
package's ``_build_pairs``, the ORB loader's tracks equal to the
pure-Python reader's on files written by ``synthetic.export_session_files``,
and a failed build raising, also through the callers."""

import shutil

import numpy as np
import pytest

from obvi_slam_tpu.solver import schur as jschur
from obvi_slam_tpu_torch import native
from obvi_slam_tpu_torch import synthetic
from obvi_slam_tpu_torch.io import readers
from obvi_slam_tpu_torch.solver import plan as plan_mod

# (rows, poses, landmarks, live share, seed): random windows, and one with
# landmarks seen once each (no cross pairs beyond the diagonal).
WINDOWS = [(5000, 60, 800, 0.9, 2), (24000, 64, 4000, 0.95, 3), (300, 8, 300, 0.5, 4),
           (1, 1, 1, 1.0, 5)]


def _window(rows, poses, lands, live, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, poses, rows), rng.integers(0, lands, rows),
            rng.random(rows) < live)


def _assert_equal_plans(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"field {i}")


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-rows")
def test_pair_plan_equals_numpy_twin(window):
    block, land, mask = _window(*window)
    _assert_equal_plans(plan_mod._build_pairs(block, land, mask),
                        plan_mod._build_pairs(block, land, mask, native=False))


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-rows")
def test_pair_plan_equals_jax(window):
    block, land, mask = _window(*window)
    caps = dict(pair_cap=None, cross_cap=None, land_cap=None, cmax_cap=None, dest_cap=None)
    _assert_equal_plans(plan_mod._build_pairs(block, land, mask, **caps),
                        jschur._build_pairs(block, land, mask, **caps))


@pytest.mark.parametrize("case", ["empty", "all-masked"])
def test_pair_plan_without_live_rows(case):
    n = 0 if case == "empty" else 4
    block, land, mask = np.zeros(n, np.int64), np.zeros(n, np.int64), np.zeros(n, bool)
    ours = plan_mod._build_pairs(block, land, mask)
    assert ours[3].sum() == 0  # no live pairs
    _assert_equal_plans(ours, plan_mod._build_pairs(block, land, mask, native=False))
    _assert_equal_plans(ours, jschur._build_pairs(block, land, mask))


def test_pair_plan_at_pinned_caps():
    """Session capacities pinned above the needs pad both alike."""
    block, land, mask = _window(*WINDOWS[2])
    caps = (4096, 65536, 1024, 32, 1024)
    _assert_equal_plans(plan_mod._build_pairs(block, land, mask, *caps),
                        plan_mod._build_pairs(block, land, mask, *caps, native=False))


def test_schur_plans_take_the_native_path(monkeypatch):
    """``build_schur_plan_host`` builds its pairs natively unless asked."""
    calls = []
    inner = native.build_pair_plan
    monkeypatch.setattr(native, "build_pair_plan", lambda *a: calls.append(1) or inner(*a))
    args = ([0, 1, 1, 2], [0, 0, 1, 1], 8, [0, 2], [0, 0], 4)
    a = plan_mod.build_schur_plan_host(*args, n_pose=3, device="cpu")
    assert len(calls) == 2  # points and objects
    b = plan_mod.build_schur_plan_host(*args, n_pose=3, device="cpu", native=False)
    assert len(calls) == 2
    for x, y in zip(a, b):
        assert (x is None and y is None) or bool((x == y).all())


def _tracks_equal(a, b):
    assert a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
    for feat, frames in a[0].items():
        assert frames.keys() == b[0][feat].keys()
        for frame, cams in frames.items():
            assert cams.keys() == b[0][feat][frame].keys()
            for cam, px in cams.items():
                assert np.array_equal(px, b[0][feat][frame][cam])
    for feat, p in a[1].items():
        assert np.array_equal(p, b[1][feat])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = tmp_path_factory.mktemp("native")
    visual = synthetic.export_session_files(
        *synthetic.synthetic_session(n_frames=8, n_features=120, seed=3)[:2], out / "visual")
    objects = synthetic.export_session_files(
        *synthetic.synthetic_object_session(n_frames=6, n_features=80, seed=50)[:2],
        out / "objects")
    return {"visual": visual, "objects": objects}


@pytest.mark.parametrize("max_frame_id", [None, 3])
@pytest.mark.parametrize("which", ["visual", "objects"])
def test_orb_loader_equals_python_reader(exported, which, max_frame_id):
    directory = str(exported[which] / "orb_out")
    ours = readers.read_orb_output_directory(directory, max_frame_id=max_frame_id)
    twin = readers.read_orb_output_directory(directory, max_frame_id=max_frame_id, native=False)
    assert ours[0]
    _tracks_equal(ours, twin)


def test_orb_loader_rows(tmp_path):
    """One row per (feature, frame, camera) observation, in file and line
    order (the JAX package's test files)."""
    f1 = tmp_path / "000003.txt"
    f1.write_text("3\n0 0 0 0 0 0 1\n7 1 100.5 200.25 2 110.0 201.0\n9 1 50 60\n")
    f2 = tmp_path / "000004.txt"
    f2.write_text("4\n0 0 0 0 0 0 1\n7 1 101.5 199.0\n")
    feat, frame, cam, px, py = native.load_orb_observations([str(f1), str(f2)])
    np.testing.assert_array_equal(feat, [7, 7, 9, 7])
    np.testing.assert_array_equal(frame, [3, 3, 3, 4])
    np.testing.assert_array_equal(cam, [1, 2, 1, 1])
    np.testing.assert_array_equal(px, [100.5, 110.0, 50.0, 101.5])
    np.testing.assert_array_equal(py, [200.25, 201.0, 60.0, 199.0])


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The native sources replaced by a copy with a syntax error, built into
    ``tmp_path``; nothing loaded yet."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.SRC / name, src / name)
    (src / native.SOURCES[0]).write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)


def test_failed_build_raises(broken_build):
    with pytest.raises(RuntimeError, match="native runtime"):
        native.load()
    assert not list(native.BUILD_DIR.glob("*.so"))


def test_failed_build_raises_through_the_callers(broken_build, exported):
    block, land, mask = _window(*WINDOWS[2])
    with pytest.raises(RuntimeError, match="native runtime"):
        plan_mod._build_pairs(block, land, mask)
    with pytest.raises(RuntimeError, match="native runtime"):
        readers.read_orb_output_directory(str(exported["visual"] / "orb_out"))
    # The twins stay reachable, by the explicit argument only.
    assert plan_mod._build_pairs(block, land, mask, native=False)[3].any()


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """An edited source builds a library of its own; a built one is reused."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.SRC / name, src / name)
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.library_path()
    native.build()
    assert first.exists() and native.build() == ""
    with open(src / native.SOURCES[1], "a") as f:
        f.write("\n// edited\n")
    assert native.library_path() != first
