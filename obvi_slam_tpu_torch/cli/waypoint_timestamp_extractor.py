"""Snap waypoint-trigger timestamps to the nearest camera-image timestamp and
label them — ``waypoint_timestamp_extractor`` equivalent (reference:
src/data_preprocessing_utils/waypoint_timestamp_extractor.cpp).

The reference reads the trigger and image timestamps from a rosbag and asks
for waypoint ids interactively on stdin; this build has no ROS runtime
(SURVEY §7 non-goal), so both streams come in as timestamp CSVs
(seconds,nanoseconds, as produced by any bag-extraction tooling) and labels
are given with --labels ("id[:r]" comma list, 'r' marking a reversed
traversal) or interactively when --labels is omitted.

Semantics preserved from the reference:
- consecutive triggers within 2000 ms are merged into one waypoint
  (kMillisThreshold, waypoint_timestamp_extractor.cpp:34,80-87);
- each surviving trigger maps to the image timestamp nearest in time
  (:175-215);
- output rows are seconds,nanoseconds,waypoint_id,reversed
  (timestamp_and_waypoint_io.h).

The port's counterpart of ``cli/waypoint_timestamp_extractor.py``:

    python -m obvi_slam_tpu_torch.cli.waypoint_timestamp_extractor --waypoint_trigger_timestamps_file triggers.csv \\
        --image_timestamps_file images.csv --timestamps_for_waypoints_out_file waypoints.csv \\
        --labels 3,4:r
"""

import argparse
import sys

from obvi_slam_tpu_torch.io import timestamped as tio

MILLIS_THRESHOLD = 2000


def dedup_triggers(stamps):
    out = []
    for ts in stamps:
        if not out:
            out.append(ts)
        elif (
            tio.timestamp_to_millis(ts) - tio.timestamp_to_millis(out[-1])
        ) > MILLIS_THRESHOLD:
            out.append(ts)
    return out


def snap_to_images(waypoint_stamps, image_stamps):
    image_millis = [tio.timestamp_to_millis(ts) for ts in image_stamps]
    snapped = []
    for wp in waypoint_stamps:
        wp_ms = tio.timestamp_to_millis(wp)
        best = min(
            range(len(image_stamps)), key=lambda i: abs(image_millis[i] - wp_ms)
        )
        snapped.append(image_stamps[best])
    return snapped


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--waypoint_trigger_timestamps_file", required=True,
                        help="CSV seconds,nanoseconds of trigger events")
    parser.add_argument("--image_timestamps_file", required=True,
                        help="CSV seconds,nanoseconds of camera images")
    parser.add_argument("--timestamps_for_waypoints_out_file", required=True)
    parser.add_argument("--labels", default=None,
                        help="comma list id[:r] per (deduped) waypoint; "
                             "interactive stdin prompt when omitted")
    args = parser.parse_args(argv)

    triggers = dedup_triggers(
        sorted(tio.read_timestamps(args.waypoint_trigger_timestamps_file))
    )
    images = sorted(tio.read_timestamps(args.image_timestamps_file))
    if not images:
        print("ERROR: no image timestamps", file=sys.stderr)
        return 1
    snapped = snap_to_images(triggers, images)

    labels = []
    if args.labels is not None:
        for item in args.labels.split(","):
            item = item.strip()
            if not item:
                continue
            if ":" in item:
                wp_id, flag = item.split(":", 1)
                labels.append((int(wp_id), flag.strip().lower() == "r"))
            else:
                labels.append((int(item), False))
        if len(labels) != len(snapped):
            print(
                f"ERROR: {len(snapped)} waypoints but {len(labels)} labels",
                file=sys.stderr,
            )
            return 1
    else:
        for i, ts in enumerate(snapped):
            line = input(f"Enter waypoint id for trigger {i} at {ts}: ")
            wp_id = int(line)
            rev = input(
                "Enter r for a reversed waypoint, any other character for "
                "not reversed: "
            )
            labels.append((wp_id, rev.strip().lower().startswith("r")))

    entries = [
        (ts, wp_id, rev) for ts, (wp_id, rev) in zip(snapped, labels)
    ]
    tio.write_timestamps_and_waypoints(
        args.timestamps_for_waypoints_out_file, entries
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
