"""Raw stereo-ORB output -> per-frame vslam input files.

Equivalent of the reference's preprocessing step
(src/data_preprocessing_utils/orb_stereo_reformat_data.py): raw ORB frontend
dumps one `<frame>_<x>_<timestamp>_..._<compared_frame>.txt` file per
consecutive-frame match (first token = frame id, third = timestamp, last =
compared frame id, which must be frame_id±1), each containing

    line 0: frame id
    line 1: pose line (x y z qx qy qz qw)
    lines 2+: feature_id x_left y_left depth x_right y_right

This reformats into the layout consumed by
``initialize_traj_and_feats_from_orb_out.py``:

    <out>/<frame>.txt          frame id, pose line, then
                               `feature_id 1 x_left y_left 2 x_right y_right`
    <out>/depths/<frame>.txt   frame id, pose line, then `feature_id depth`

Negative-depth features are dropped (reference `add_to_features`, :23).
Delta vs reference: when a frame has several match files, features are merged
across them (the reference reopens the output in "w" mode per input file, so
only the last file survives — an apparent bug we do not replicate).

The port's counterpart of ``cli/orb_stereo_reformat_data.py``:

    python -m obvi_slam_tpu_torch.cli.orb_stereo_reformat_data -i raw_matches -o orb_out
"""

import argparse
import os
import shutil
import sys
import warnings
from collections import defaultdict


def parse_feature_line(line):
    tokens = line.split()
    try:
        feature_id = int(tokens[0])
        x1, y1, depth = float(tokens[1]), float(tokens[2]), float(tokens[3])
        x2, y2 = float(tokens[4]), float(tokens[5])
    except (ValueError, IndexError):
        return None
    if depth < 0:
        return None
    return feature_id, (depth, x1, y1, x2, y2)


def collect_input_files(input_path):
    """Map (frame_id, timestamp) -> list of raw match-file paths."""
    by_frame = defaultdict(list)
    for filename in sorted(os.listdir(input_path)):
        if not filename.endswith(".txt"):
            continue
        tokens = filename.split("_")
        try:
            frame_id = int(tokens[0])
            compared = int(tokens[-1].split(".")[0])
            timestamp = float(tokens[2])
        except (ValueError, IndexError):
            print(f"unparseable filename: {filename}", file=sys.stderr)
            continue
        if compared not in (frame_id - 1, frame_id + 1):
            warnings.warn("Unexpected Filename: " + filename)
            continue
        by_frame[(frame_id, timestamp)].append(os.path.join(input_path, filename))
    return by_frame


def reformat(input_path, output_path):
    by_frame = collect_input_files(input_path)
    if os.path.exists(output_path):
        shutil.rmtree(output_path)
    depth_dir = os.path.join(output_path, "depths")
    os.makedirs(depth_dir, exist_ok=True)

    for (frame_id, _ts), paths in sorted(by_frame.items()):
        features = {}
        pose_line = None
        for path in paths:
            with open(path) as f:
                lines = f.readlines()
            if len(lines) < 2:
                print(f"unexpected file length from file {path}", file=sys.stderr)
                sys.exit(1)
            assert lines[0].strip() == str(frame_id), path
            pose_line = lines[1].rstrip("\n")
            for line in lines[2:]:
                parsed = parse_feature_line(line)
                if parsed is not None:
                    features[parsed[0]] = parsed[1]
        with open(os.path.join(output_path, f"{frame_id}.txt"), "w") as out, open(
            os.path.join(depth_dir, f"{frame_id}.txt"), "w"
        ) as dout:
            out.write(f"{frame_id}\n{pose_line}\n")
            dout.write(f"{frame_id}\n{pose_line}\n")
            for fid, (depth, x1, y1, x2, y2) in features.items():
                out.write(f"{fid} 1 {x1} {y1} 2 {x2} {y2}\n")
                dout.write(f"{fid} {depth}\n")
    return len(by_frame)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input", required=True, help="raw orb output dir")
    parser.add_argument("-o", "--output", required=True, help="reformatted output dir")
    args = parser.parse_args(argv)
    n = reformat(args.input, args.output)
    print(f"reformatted {n} frames -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
