"""Sessions chained through the long-term map: the port's counterpart of
``cli/sequence_executor.py`` (the reference's
``ltm_trajectory_sequence_executor.py``). Runs each session of a sequence
through ``offline_object_visual_slam_main`` in a process of its own,
passing the previous session's long-term map as the next one's input:

    python -m obvi_slam_tpu_torch.cli.sequence_executor \\
        --sequence_file sequence.json --output_dir out \\
        --params_config_file config.json [--device cpu] [--f64]

The sequence file is a JSON list of sessions, each a dict with the input
paths of the main entry point (``intrinsics_file``, ``extrinsics_file``,
``poses_by_node_id_file``, ``low_level_feats_dir``, optionally
``bounding_boxes_by_node_id_file``) and an optional ``name``. Each
session's results go to ``<output_dir>/<name>/``: ``long_term_map.json``,
``robot_poses.csv``, ``ellipsoids.csv``, ``features.csv``,
``bb_assoc.json``, ``timing.json`` and ``ceres_opt_summary.csv``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# The directory that holds the obvi_slam_tpu_torch package.
ROOT = Path(__file__).resolve().parents[2]
MAIN = "obvi_slam_tpu_torch.cli.offline_object_visual_slam_main"


def session_command(session: dict, out: str, args, prev_ltm=None):
    """The main entry point's argv for one session of the sequence."""
    cmd = [
        sys.executable, "-m", MAIN,
        "--params_config_file", args.params_config_file,
        "--intrinsics_file", session["intrinsics_file"],
        "--extrinsics_file", session["extrinsics_file"],
        "--poses_by_node_id_file", session["poses_by_node_id_file"],
        "--low_level_feats_dir", session["low_level_feats_dir"],
        "--long_term_map_output", os.path.join(out, "long_term_map.json"),
        "--robot_poses_results_file", os.path.join(out, "robot_poses.csv"),
        "--ellipsoids_results_file", os.path.join(out, "ellipsoids.csv"),
        "--visual_feature_results_file", os.path.join(out, "features.csv"),
        "--bb_associations_out_file", os.path.join(out, "bb_assoc.json"),
        "--timing_report_file", os.path.join(out, "timing.json"),
        "--opt_log_file", os.path.join(out, "ceres_opt_summary.csv"),
        "--device", args.device,
    ]
    if session.get("bounding_boxes_by_node_id_file"):
        cmd += ["--bounding_boxes_by_node_id_file", session["bounding_boxes_by_node_id_file"]]
    if prev_ltm:
        cmd += ["--long_term_map_input", prev_ltm]
    if args.f64:
        cmd.append("--f64")
    return cmd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Sessions chained through the LTM.")
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="passed to every session (default cuda)")
    parser.add_argument("--f64", action="store_true", help="passed to every session")
    args = parser.parse_args(argv)

    with open(args.sequence_file) as f:
        sessions = json.load(f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p
    )
    prev_ltm = None
    for i, session in enumerate(sessions):
        name = session.get("name", f"session_{i}")
        out = os.path.join(args.output_dir, name)
        os.makedirs(out, exist_ok=True)
        print(f"[sequence] running {name} ...", flush=True)
        result = subprocess.run(session_command(session, out, args, prev_ltm), env=env)
        if result.returncode != 0:
            print(f"[sequence] session {name} FAILED", file=sys.stderr)
            return result.returncode
        prev_ltm = os.path.join(out, "long_term_map.json")
    print("[sequence] all sessions complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
