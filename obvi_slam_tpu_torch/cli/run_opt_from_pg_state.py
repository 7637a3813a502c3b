"""Resume a session from a pose-graph checkpoint: the port's counterpart of
``cli/run_opt_from_pg_state.py`` (the reference's ``run_opt_from_pg_state``).
Loads the checkpointed pose graph (``pose_graph_state*.json`` of the main
entry point's ``--checkpoint_output_dir``), restarts the per-frame loop at
``--start_at_frame`` (the frames before it are in the graph already) and
writes the results:

    python -m obvi_slam_tpu_torch.cli.run_opt_from_pg_state \\
        --input_checkpoint_file ckpt.json --start_at_frame 5 \\
        --params_config_file config.json --intrinsics_file intrinsics.csv \\
        --extrinsics_file extrinsics.csv --poses_by_node_id_file poses.csv \\
        --low_level_feats_dir orb_out --robot_poses_results_file poses_out.csv \\
        [--device cpu] [--f64]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch import io as oio
from obvi_slam_tpu_torch.cli._common import check_device, disable_tf32, read_problem_data
from obvi_slam_tpu_torch.frontend import (
    FeatureBasedBoundingBoxFrontEnd,
    VisualFeatureFrontend,
    apply_merges,
    make_bb_frontend_hook,
    merge_objects_by_center_proximity,
)
from obvi_slam_tpu_torch.ltm import extract_long_term_object_map
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.runner import OfflineProblemRunner, RunnerHooks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Resume a session from a checkpoint.")
    parser.add_argument("--input_checkpoint_file", required=True)
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--intrinsics_file", required=True)
    parser.add_argument("--extrinsics_file", required=True)
    parser.add_argument("--poses_by_node_id_file", required=True)
    parser.add_argument("--bounding_boxes_by_node_id_file", default="")
    parser.add_argument("--low_level_feats_dir", required=True)
    parser.add_argument("--start_at_frame", type=int, required=True)
    parser.add_argument("--run_data_adder_for_first_frame", action="store_true")
    parser.add_argument("--robot_poses_results_file", default="")
    parser.add_argument("--ellipsoids_results_file", default="")
    parser.add_argument("--long_term_map_output", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the solves (default cuda; cpu runs on the CPU)")
    parser.add_argument("--f64", action="store_true", help="double-precision solves")
    args = parser.parse_args(argv)
    disable_tf32()
    check_device(args.device)
    dtype = np.float64 if args.f64 else np.float32

    config = cfg.read_config(args.params_config_file)
    data, img_hw, _ = read_problem_data(args)
    with open(args.input_checkpoint_file) as f:
        state = json.load(f)
    pg = PoseGraph.from_state(state, data.cameras, cfg.shape_prior_map(config))
    print(
        f"resumed checkpoint: {len(pg.robot_poses)} frames, "
        f"{len(pg.features)} features, {len(pg.objects)} objects"
    )

    bb_frontend = FeatureBasedBoundingBoxFrontEnd(
        pg,
        config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params,
        img_heights_and_widths=img_hw,
        dtype=dtype, device=args.device,
    )
    merge = config.post_session_object_merge_params
    hooks = RunnerHooks(
        bb_frontend=make_bb_frontend_hook(bb_frontend) if data.bounding_boxes else None,
        object_merger=lambda p: apply_merges(
            p,
            merge_objects_by_center_proximity(p, merge.max_merge_distance,
                                              merge.x_y_only_merge),
            bb_frontend,
        ),
    )
    runner = OfflineProblemRunner(config, hooks, dtype=dtype, device=args.device)
    max_frame = max(data.initial_poses)
    # Features already in the graph count as added, so their new
    # observations go through the epipolar gate.
    vf = VisualFeatureFrontend(
        gba_checker=lambda fr: runner._gba_checker(fr, max_frame),
        reprojection_error_provider=lambda *a: (
            config.visual_feature_params.reprojection_error_std_dev),
    )
    vf.added_feature_ids = set(pg.features)

    ok = runner.run_optimization(
        data, pg, visual_frontend=vf, start_at_frame=args.start_at_frame,
        add_data_for_starting_frame=args.run_data_adder_for_first_frame,
    )
    if not ok:
        return 1
    if args.robot_poses_results_file:
        oio.write_robot_pose_results(args.robot_poses_results_file, pg)
    if args.ellipsoids_results_file:
        oio.write_ellipsoid_results(args.ellipsoids_results_file, pg)
    if args.long_term_map_output:
        ltm = extract_long_term_object_map(
            pg, config, bb_frontend.get_front_end_obj_map_data(), device=args.device
        )
        if ltm is not None:
            ltm.save(args.long_term_map_output)
    print(f"resume complete: {len(pg.robot_poses)} frames, {len(pg.objects)} objects")
    return 0


if __name__ == "__main__":
    sys.exit(main())
