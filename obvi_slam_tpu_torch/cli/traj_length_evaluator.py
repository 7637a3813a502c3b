"""Total path length of (ground-truth) trajectories —
``lego_loam_traj_length_evaluator`` equivalent (reference:
src/evaluation/lego_loam_traj_length_evaluator.cpp:150-166: sum of
consecutive-pose translation-delta norms per trajectory, plus the sequence
total).

Takes one or more timestamped-pose CSVs and prints per-trajectory and total
lengths (also written as JSON when --output_file is given).

The port's counterpart of ``cli/traj_length_evaluator.py``:

    python -m obvi_slam_tpu_torch.cli.traj_length_evaluator --trajectory_files a.csv,b.csv [--output_file lengths.json]
"""

import argparse
import json
import sys

import numpy as np

from obvi_slam_tpu_torch.io import timestamped as tio


def traj_length(poses) -> float:
    pts = np.array([p[:3] for p in poses])
    if len(pts) < 2:
        return 0.0
    return float(np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=1)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--trajectory_files", required=True,
                        help="comma-separated timestamped-pose CSVs")
    parser.add_argument("--output_file", default=None)
    args = parser.parse_args(argv)

    lengths = {}
    for path in args.trajectory_files.split(","):
        path = path.strip()
        if not path:
            continue
        entries = tio.read_poses_with_timestamps(path)
        lengths[path] = traj_length([p for _, p in entries])

    total = float(sum(lengths.values()))
    for path, length in lengths.items():
        print(f"{path}: {length:.3f} m")
    print(f"total: {total:.3f} m")

    if args.output_file:
        with open(args.output_file, "w") as f:
            json.dump({"per_trajectory": lengths, "total": total}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
