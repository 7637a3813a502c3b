"""The long-term map from a pose-graph checkpoint: the port's counterpart of
``cli/ltm_extraction_only.py`` (the reference's ``ltm_extraction_only``):

    python -m obvi_slam_tpu_torch.cli.ltm_extraction_only \\
        --input_checkpoint_file long_term_map_checkpoint.json \\
        --params_config_file config.json --intrinsics_file intrinsics.csv \\
        --extrinsics_file extrinsics.csv --long_term_map_output ltm.json \\
        [--previous_long_term_map prev.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch.cli._common import check_device, disable_tf32, read_cameras
from obvi_slam_tpu_torch.ltm import LongTermObjectMap, extract_long_term_object_map
from obvi_slam_tpu_torch.pose_graph import PoseGraph


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The LTM from a pose-graph checkpoint.")
    parser.add_argument("--input_checkpoint_file", required=True)
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--intrinsics_file", required=True)
    parser.add_argument("--extrinsics_file", required=True)
    parser.add_argument("--long_term_map_output", required=True)
    parser.add_argument("--previous_long_term_map", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the extraction (default cuda; cpu runs on the CPU)")
    args = parser.parse_args(argv)
    disable_tf32()
    check_device(args.device)

    config = cfg.read_config(args.params_config_file)
    cameras, _, _ = read_cameras(args.intrinsics_file, args.extrinsics_file)
    with open(args.input_checkpoint_file) as f:
        pg = PoseGraph.from_state(json.load(f), cameras, cfg.shape_prior_map(config))
    prev = (
        LongTermObjectMap.load(args.previous_long_term_map)
        if args.previous_long_term_map
        else None
    )
    ltm = extract_long_term_object_map(pg, config, {}, prev_ltm=prev, device=args.device)
    if ltm is None:
        print("LTM extraction failed", file=sys.stderr)
        return 1
    ltm.save(args.long_term_map_output)
    print(f"extracted LTM with {len(ltm.ellipsoids)} objects")
    return 0


if __name__ == "__main__":
    sys.exit(main())
