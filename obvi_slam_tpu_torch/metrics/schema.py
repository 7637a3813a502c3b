"""Reference metric-file schema interop (``approach_metrics.py:574-615``).

The reference's evaluation stack (approach_metrics.py readMetricsFile /
readObjectsMetricsFile and every plotter built on them) consumes JSON metric
files with cv::FileStorage conventions: vectors serialized as
``[{"value": v}, ...]`` (custom_json_file_parsing.py:9-13) and the exact key
names of ``MetricsFileConstants``. These writers/readers emit and parse that
schema verbatim so our outputs drop into the reference's comparison/plotting
pipeline unchanged and vice versa.

This module is a copy of ``obvi_slam_tpu/metrics/schema.py`` (standard
library only); the port keeps its own copy and imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from obvi_slam_tpu_torch.metrics.trajectory import (
    ATEResults,
    MetricsDistributionStatistics,
)

# MetricsFileConstants (approach_metrics.py:574-615).
METRICS_KEY = "metrics"
INDIV_TRAJECTORY_METRICS = "indiv_trajectory_metrics"
SEQUENCE_METRICS = "sequence_metrics"
ATE_RESULTS = "trajectory_sequence_ate_results"
RPE_RESULTS = "trajectory_sequence_rpe_results"
OBJECT_METRICS_KEY = "obj_metrics"
INDIV_TRAJECTORY_OBJECT_METRICS = "indiv_trajectory_object_metrics"


def _vec(values) -> List[dict]:
    """cv::FileStorage vector convention (custom_json_file_parsing.py:9)."""
    return [{"value": float(v)} for v in (values or [])]


def _unvec(json_vec) -> List[float]:
    return [entry["value"] for entry in json_vec]


def stats_to_ref_json(s: MetricsDistributionStatistics) -> dict:
    return {
        "num_vals": s.num_vals,
        "average": s.average,
        "std_dev": s.std_dev,
        "median": s.median,
        "min": s.min,
        "max": s.max,
        "lower_quartile": s.lower_quartile,
        "upper_quartile": s.upper_quartile,
        "rmse": s.rmse,
        "squared_err_std_dev": s.squared_err_std_dev,
        "errors": _vec(s.errors),
    }


def stats_from_ref_json(d: dict) -> MetricsDistributionStatistics:
    return MetricsDistributionStatistics(
        num_vals=d["num_vals"],
        average=d["average"],
        std_dev=d["std_dev"],
        median=d["median"],
        min=d["min"],
        max=d["max"],
        lower_quartile=d["lower_quartile"],
        upper_quartile=d["upper_quartile"],
        rmse=d["rmse"],
        squared_err_std_dev=d["squared_err_std_dev"],
        errors=_unvec(d["errors"]),
    )


def ate_to_ref_json(a: ATEResults) -> dict:
    return {
        "rmse_transl_err": a.rmse_transl_err,
        "rmse_rot_err": a.rmse_rot_err,
        "transl_stats": stats_to_ref_json(a.transl_stats),
        "rot_stats": stats_to_ref_json(a.rot_stats),
        "valid_poses_used_in_score": a.valid_poses_used_in_score,
        "lost_poses": a.lost_poses,
    }


def ate_from_ref_json(d: dict) -> ATEResults:
    def _inf(v):
        return float("inf") if v < 0 else v

    return ATEResults(
        rmse_transl_err=_inf(d["rmse_transl_err"]),
        rmse_rot_err=_inf(d["rmse_rot_err"]),
        transl_stats=stats_from_ref_json(d["transl_stats"]),
        rot_stats=stats_from_ref_json(d["rot_stats"]),
        valid_poses_used_in_score=d["valid_poses_used_in_score"],
        lost_poses=d["lost_poses"],
    )


def trajectory_metrics_to_ref_json(
    ate: ATEResults,
    rpe: Optional[ATEResults] = None,
    waypoint_deviations: Optional[Dict] = None,
    all_translation_deviations=None,
    all_rotation_deviations=None,
) -> dict:
    out = {
        "waypoint_deviations": waypoint_deviations or {},
        "all_translation_deviations": _vec(all_translation_deviations),
        "all_rotation_deviations": _vec(all_rotation_deviations),
        ATE_RESULTS: ate_to_ref_json(ate),
    }
    if rpe is not None:
        out[RPE_RESULTS] = ate_to_ref_json(rpe)
    return out


def write_metrics_file(
    path: str,
    sequence_metrics: dict,
    indiv_trajectory_metrics: List[dict],
):
    """Full-sequence trajectory metrics file, readMetricsFile-compatible."""
    with open(path, "w") as f:
        json.dump(
            {
                METRICS_KEY: {
                    SEQUENCE_METRICS: sequence_metrics,
                    INDIV_TRAJECTORY_METRICS: [
                        {"value": m} for m in indiv_trajectory_metrics
                    ],
                }
            },
            f,
            indent=1,
        )


def read_metrics_file(path: str):
    """Parse a reference (or ours) metrics file: (sequence, [indiv...]),
    each {"ate": ATEResults, "rpe": ATEResults|None,
    "all_translation_deviations": [...], "all_rotation_deviations": [...]}."""
    with open(path) as f:
        d = json.load(f)
    seq_json = d[METRICS_KEY]

    def parse_traj(m):
        return {
            "ate": ate_from_ref_json(m[ATE_RESULTS]),
            "rpe": ate_from_ref_json(m[RPE_RESULTS]) if RPE_RESULTS in m else None,
            "all_translation_deviations": _unvec(
                m["all_translation_deviations"]
            ),
            "all_rotation_deviations": _unvec(m["all_rotation_deviations"]),
        }

    seq = parse_traj(seq_json[SEQUENCE_METRICS])
    indiv = [
        parse_traj(e["value"]) for e in seq_json[INDIV_TRAJECTORY_METRICS]
    ]
    return seq, indiv


def object_metrics_to_ref_json(m) -> dict:
    """SingleTrajectoryObjectMetrics -> reference keys
    (approach_metrics.py:592-601)."""
    return {
        "missed_gt_objs": m.missed_gt_objs,
        "recall": m.recall,
        "num_gt_objs": m.num_gt_objs,
        "objects_per_gt_obj": m.objects_per_gt_obj,
        "average_pos_deviation": m.average_pos_deviation,
        "avg_iou": m.avg_iou,
        "median_pos_deviation": m.median_pos_deviation,
        "median_iou": m.median_iou,
        "pos_dev_stats": stats_to_ref_json(m.pos_dev_stats),
        "iou_stats": stats_to_ref_json(m.iou_stats),
    }


def write_object_metrics_file(path: str, indiv_metrics: List[dict]):
    """readObjectsMetricsFile-compatible object metrics file."""
    with open(path, "w") as f:
        json.dump(
            {
                OBJECT_METRICS_KEY: {
                    INDIV_TRAJECTORY_OBJECT_METRICS: [
                        {"value": m} for m in indiv_metrics
                    ]
                }
            },
            f,
            indent=1,
        )


def read_object_metrics_file(path: str) -> List[dict]:
    with open(path) as f:
        d = json.load(f)
    out = []
    for e in d[OBJECT_METRICS_KEY][INDIV_TRAJECTORY_OBJECT_METRICS]:
        m = dict(e["value"])
        m["pos_dev_stats"] = stats_from_ref_json(m["pos_dev_stats"])
        m["iou_stats"] = stats_from_ref_json(m["iou_stats"])
        out.append(m)
    return out
