"""Object-map metrics — the ``object_metrics_generator`` equivalent
(src/evaluation/object_metrics_generator.cpp + object_evaluation_utils.h):
recall, missed GT objects, objects-per-GT, position deviation, volumetric
IoU vs a ground-truth object file.

The port's counterpart of ``cli/object_metrics_generator.py``:

    python -m obvi_slam_tpu_torch.cli.object_metrics_generator \\
        --est_objects_file ellipsoids.csv --gt_objects_file gt_objects.csv \\
        --metrics_out_file object_metrics.json
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--est_objects_file", required=True, help="ellipsoids.csv result")
    parser.add_argument("--gt_objects_file", required=True, help="same schema")
    parser.add_argument("--metrics_out_file", required=True)
    parser.add_argument("--max_assoc_dist", type=float, default=4.0)
    parser.add_argument(
        "--ref_schema_out_file",
        default="",
        help="also write the reference's object-metrics schema "
        "(readObjectsMetricsFile-compatible, approach_metrics.py:592-601)",
    )
    args = parser.parse_args(argv)

    import obvi_slam_tpu_torch.metrics as M
    from obvi_slam_tpu_torch.io.writers import read_ellipsoid_results

    est = read_ellipsoid_results(args.est_objects_file)
    gt = read_ellipsoid_results(args.gt_objects_file)
    m = M.object_metrics(est, gt, max_assoc_dist=args.max_assoc_dist)

    out = {
        "recall": m.recall,
        "num_gt_objs": m.num_gt_objs,
        "missed_gt_objs": m.missed_gt_objs,
        "objects_per_gt_obj": m.objects_per_gt_obj,
        "average_pos_deviation": m.average_pos_deviation,
        "median_pos_deviation": m.median_pos_deviation,
        "avg_iou": m.avg_iou,
        "median_iou": m.median_iou,
        "iou_for_gt_obj": {str(k): v for k, v in m.iou_for_gt_obj.items()},
        "pos_diff_for_est_obj": {
            str(k): v for k, v in m.pos_diff_for_est_obj.items()
        },
    }
    with open(args.metrics_out_file, "w") as f:
        json.dump(out, f, indent=1)
    if args.ref_schema_out_file:
        from obvi_slam_tpu_torch.metrics import schema as S

        S.write_object_metrics_file(
            args.ref_schema_out_file, [S.object_metrics_to_ref_json(m)]
        )
    print(
        f"recall={m.recall:.3f} missed={m.missed_gt_objs}/{m.num_gt_objs} "
        f"avg_pos_dev={m.average_pos_deviation:.3f}m avg_iou={m.avg_iou:.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
