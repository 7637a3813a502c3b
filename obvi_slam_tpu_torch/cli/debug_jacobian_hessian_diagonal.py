"""Hessian-diagonal / Jacobian debugging, the port's counterpart of
``cli/debug_jacobian_hessian_diagonal.py`` (the reference's
``debug_jacobian_hessian_diagonal`` and ``visualize_jacobian_problem_feats``):
loads a pose-graph checkpoint, extracts the full sparse Jacobian at the
current state (reprojection and bounding-box blocks through kernels K1 and
K2 on the card), reports zero and small columns (unconstrained parameters)
and Hessian-diagonal statistics, and optionally writes the sparse triplets
and the column attribution as CSV:

    python -m obvi_slam_tpu_torch.cli.debug_jacobian_hessian_diagonal \\
        --input_checkpoint_file pose_graph_state.json \\
        --params_config_file config.json --intrinsics_file intrinsics.csv \\
        --extrinsics_file extrinsics.csv [--jacobian_output_file jac.csv] \\
        [--min_col_norm 5e-4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch.cli._common import check_device, disable_tf32, read_cameras
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.solver import jacobian_debug as jd
from obvi_slam_tpu_torch.solver.problem import Scope, build_problem


def load_problem(checkpoint_file, params_config_file, intrinsics_file, extrinsics_file,
                 device="cuda"):
    """The whole-graph problem (every frame, the config's observation
    minimums) of a pose-graph checkpoint, on ``device`` in f64."""
    config = cfg.read_config(params_config_file)
    cameras, _, _ = read_cameras(intrinsics_file, extrinsics_file)
    with open(checkpoint_file) as f:
        pg = PoseGraph.from_state(json.load(f), cameras, cfg.shape_prior_map(config))
    en = config.optimization_factors_enabled_params
    scope = Scope(
        min_frame_id=0,
        max_frame_id=pg.max_frame_id(),
        min_object_observations=en.min_object_observations,
        min_low_level_feature_observations=en.min_low_level_feature_observations,
        min_low_level_feature_observations_per_frame=en.min_low_level_feature_observations_per_frame,
    )
    return build_problem(
        pg, scope, config.object_visual_pose_graph_residual_params, device=device
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Jacobian and Hessian-diagonal report of a pose-graph checkpoint.")
    parser.add_argument("--input_checkpoint_file", required=True)
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--intrinsics_file", required=True)
    parser.add_argument("--extrinsics_file", required=True)
    parser.add_argument("--jacobian_output_file", default="")
    parser.add_argument("--min_col_norm", type=float, default=5e-4)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the extraction (default cuda; cpu runs on the CPU)")
    args = parser.parse_args(argv)
    disable_tf32()
    check_device(args.device)

    problem = load_problem(args.input_checkpoint_file, args.params_config_file,
                           args.intrinsics_file, args.extrinsics_file, args.device)
    info = jd.extract_jacobian(problem.state, problem.cams, problem.tables, problem.huber)
    hdiag = jd.hessian_diagonal(info)
    free_cols = np.concatenate([
        np.repeat(problem.free.poses.cpu().numpy(), 6),
        np.repeat(problem.free.points.cpu().numpy(), 3),
        np.repeat(problem.free.objects.cpu().numpy(), 7),
    ])
    zeros = jd.validate_zero_columns(info, free_cols)
    small = np.nonzero((np.sqrt(np.maximum(hdiag, 0)) < args.min_col_norm) & free_cols)[0]
    print(f"Jacobian: {info.n_rows} rows x {info.n_cols} cols, {len(info.vals)} nonzeros")
    print(
        f"Hessian diag: min={hdiag.min():.3e} max={hdiag.max():.3e} "
        f"median={np.median(hdiag):.3e}"
    )
    print(f"zero columns (free params): {len(zeros)}")
    for kind, row, param, norm in zeros[:20]:
        print(f"  ZERO {kind}[{row}].{param} norm={norm:.2e}")
    print(f"columns below min_col_norm({args.min_col_norm}): {len(small)}")
    if args.jacobian_output_file:
        jd.write_jacobian_csv(info, args.jacobian_output_file)
        print(f"wrote {args.jacobian_output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
