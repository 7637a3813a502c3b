"""Two object sessions of one scene chained through the long-term map by
the port's sequence executor on the CPU (each session in a process of its
own, through the port's main CLI): the second observes the first's map
objects again."""

import json

import torch

from obvi_slam_tpu import config as jcfg
import obvi_slam_tpu_torch as ot
from obvi_slam_tpu_torch.cli import sequence_executor
from obvi_slam_tpu_torch.io import read_bb_association_results
from torch_cli_helpers import export
from torch_object_helpers import ASYM_DIMS, object_config

torch.set_num_threads(1)


def test_sequence_executor_reobserves_map_objects(tmp_path):
    """Two 10-frame sessions of one scene (other noise) chained through the
    LTM by the port's sequence executor, each in a process of its own on the
    CPU: the second observes the first's map objects again."""
    sessions = []
    for k, seed in enumerate((21, 99)):
        data, gt, _ = ot.synthetic_object_session(n_frames=10, seed=seed, dims=ASYM_DIMS)
        d = export(data, gt, tmp_path / f"s{k}", object_config(jcfg, ASYM_DIMS))
        sessions.append(dict(
            name=f"s{k}", intrinsics_file=str(d / "intrinsics.csv"),
            extrinsics_file=str(d / "extrinsics.csv"),
            poses_by_node_id_file=str(d / "poses.csv"),
            low_level_feats_dir=str(d / "orb_out"),
            bounding_boxes_by_node_id_file=str(d / "bounding_boxes.csv")))
    (tmp_path / "sequence.json").write_text(json.dumps(sessions))
    assert sequence_executor.main([
        "--sequence_file", str(tmp_path / "sequence.json"), "--output_dir", str(tmp_path / "out"),
        "--params_config_file", str(tmp_path / "s0" / "config.json"),
        "--device", "cpu", "--f64"]) == 0
    first = ot.LongTermObjectMap.load(str(tmp_path / "out" / "s0" / "long_term_map.json"))
    assert len(first.ellipsoids) == 2
    _, assoc = read_bb_association_results(str(tmp_path / "out" / "s1" / "bb_assoc.json"))
    again = sorted(o for o in first.ellipsoids if assoc.get(o))
    assert again, (sorted(first.ellipsoids), sorted(assoc))
    assert (tmp_path / "out" / "s1" / "long_term_map.json").exists()
