"""The LTM counters of a failed extraction and of a merge into an LTM
object, on small hand-made pose graphs, and the ``objects.ltm_revisit``
cell's readers on hand-made records (a session seeded from a map, its
extraction and its spans: ``test_torch_ltm_sequence.py``)."""

import numpy as np
import pytest

import obvi_slam_tpu_torch as ot
from benchmark import harness
from obvi_slam_tpu_torch import config as pcfg
from obvi_slam_tpu_torch import ltm as pltm
from obvi_slam_tpu_torch.frontend import apply_merges, merge_objects_by_center_proximity
from torch_object_helpers import ASYM_DIMS, object_config, port_frontend

CHAIR = [1.0, 0.0, 6.0, 0, 0.5, 0.8, 0.975]


@pytest.fixture
def graph():
    """(an empty pose graph with two frames' cameras, its config)."""
    config = object_config(pcfg, ASYM_DIMS)
    data, _, _ = ot.synthetic_object_session(n_frames=2, n_objects=1, n_features=8,
                                             dims=ASYM_DIMS, seed=32)
    return ot.PoseGraph(data.cameras, pcfg.shape_prior_map(config)), config


def test_fallback_is_counted(graph, monkeypatch):
    pg, config = graph
    prev = pltm.LongTermObjectMap(ellipsoids={7: ("chair", np.array(CHAIR))},
                                  covariances={7: np.eye(7)})
    monkeypatch.setattr(pltm, "_extract", lambda *a, **k: None)
    pltm.reset_ltm_stats()
    out = ot.extract_long_term_object_map(pg, config, prev_ltm=prev, device="cpu")
    assert out is prev
    assert pltm.ltm_stats["fallbacks"] == 1 and pltm.ltm_stats["extractions"] == 1


def test_merge_into_an_ltm_object_is_counted(graph):
    pg, config = graph
    pg.add_ltm_object(7, np.array(CHAIR), "chair")
    pg.add_new_ellipsoid([1.3, 0.1, 6.0, 0, 0.5, 0.8, 0.975], "chair")
    pg.add_new_ellipsoid([9.0, 0.1, 6.0, 0, 0.5, 0.8, 0.975], "chair")
    fe = port_frontend(pg, config)
    assert fe.ltm_merges == 0
    assert apply_merges(pg, merge_objects_by_center_proximity(pg, 2.0, True), fe)
    assert fe.ltm_merges == 1 and set(pg.objects) == {7, 9}

TIMERS = {"optimization_iteration": 40.0, "ltm_extraction": 0.9, "ltm_covariance": 0.12,
          "ltm_rank_check": 0.03, "ltm_far_features": 0.5, "ltm_psd": 0.001}
READERS = {"ltm_covariance_ms.sequence": 120.0, "ltm_rank_check_ms.sequence": 30.0,
           "ltm_far_features_ms.sequence": 500.0, "ltm_covariance_device_ms.sequence": 40.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_hand_made_record(name):
    reader = harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"metric_{name}")
    record = dict(frames=50, timers=TIMERS, ltm_device_ms={"ltm_covariance": 40.0})
    assert reader.read(record) == pytest.approx(READERS[name], rel=1e-12)
    # A program without the spans (the parent's timers): nothing to read.
    assert reader.read(dict(frames=50, timers={"optimization_iteration": 40.0},
                            ltm_device_ms={})) is None
    assert reader.read({"frames": 0, "trace": None}) is None
