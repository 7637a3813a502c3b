"""Re-key estimated poses from frame/node id to timestamp —
``utvslam_out_to_poses_by_timestamp`` equivalent
(reference: src/evaluation/trajectory_formatting/utvslam_out_to_poses_by_timestamp.cpp).

Inputs: the robot-pose results CSV written by the main pipeline
(node_id keyed) and a node-id→timestamp map; output is the
optional-pose-by-timestamp CSV consumed by the metrics tooling. Nodes
missing from the results are reported and skipped (the reference does the
same — utvslam_out_to_poses_by_timestamp.cpp:60-71).

The port's counterpart of ``cli/utvslam_out_to_poses_by_timestamp.py``:

    python -m obvi_slam_tpu_torch.cli.utvslam_out_to_poses_by_timestamp --poses_by_frame_file robot_poses.csv \\
        --frames_for_timestamps_file nodes.csv --poses_by_timestamp_out_file by_ts.csv
"""

import argparse
import sys

from obvi_slam_tpu_torch.io import timestamped as tio


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--poses_by_frame_file", required=True,
                        help="robot pose results CSV (node_id,tx,..,qw)")
    parser.add_argument("--frames_for_timestamps_file", required=True,
                        help="CSV: node_id,seconds,nanoseconds (header)")
    parser.add_argument("--poses_by_timestamp_out_file", required=True)
    args = parser.parse_args(argv)

    poses = tio.read_robot_pose_results(args.poses_by_frame_file)
    nodes_ts = tio.read_node_ids_and_timestamps(args.frames_for_timestamps_file)

    entries = []
    for node_id, ts in nodes_ts:
        if node_id not in poses:
            print(
                f"ERROR: no pose for node {node_id} "
                f"(timestamp {ts[0]}, {ts[1]}); skipping",
                file=sys.stderr,
            )
            continue
        entries.append((ts, poses[node_id]))

    tio.write_optional_poses_with_timestamps(
        args.poses_by_timestamp_out_file, entries
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
