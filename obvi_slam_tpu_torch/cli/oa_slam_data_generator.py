"""Export a session's images + detections in OA-SLAM's input layout —
``oa_slam_data_generator`` equivalent (reference:
src/evaluation/oa_slam/oa_slam_data_generator.cpp:95-201).

The reference pulls images from a rosbag and detections from the live YOLO
ROS service; this build has no ROS runtime, so images come from a directory
tree (<images_root>/<cam_id>/<frame_id>.png) and detections from the
precomputed bounding-box CSV the main pipeline already consumes.

Output layout (per camera id):
  <out>/<cam>/<frame>.png                      — copied images
  <out>/<cam>/cam_<cam>_images.txt             — relative image paths
  <out>/<cam>/detections/detections.txt        — blocks of
        file_name / <rel path> / detections / (category_id, detection_score,
        bbox "min_x,min_y,max_x,max_y") per detection
matching oa_slam_data_generator.cpp:170-190.

The port's counterpart of ``cli/oa_slam_data_generator.py``:

    python -m obvi_slam_tpu_torch.cli.oa_slam_data_generator --images_root_directory images \\
        --bounding_boxes_by_node_id_file bounding_boxes.csv --nodes_by_timestamp_file nodes.csv \\
        --class_ids_file classes.csv --oa_slam_data_output_directory oa_out
"""

import argparse
import os
import shutil
import sys
from pathlib import Path

from obvi_slam_tpu_torch.io import timestamped as tio
from obvi_slam_tpu_torch.io.readers import read_bounding_boxes_by_node_id


def read_class_ids(path):
    """CSV class_name,class_id (header)."""
    out = {}
    with open(path) as f:
        for line in f.read().strip().splitlines()[1:]:
            name, cid = [c.strip() for c in line.split(",")[:2]]
            out[name] = int(cid)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--images_root_directory", required=True,
                        help="<root>/<cam_id>/<frame_id>.png tree")
    parser.add_argument("--bounding_boxes_by_node_id_file", required=True)
    parser.add_argument("--nodes_by_timestamp_file", required=True)
    parser.add_argument("--class_ids_file", required=True,
                        help="CSV class_name,class_id")
    parser.add_argument("--oa_slam_data_output_directory", required=True)
    args = parser.parse_args(argv)

    bbs = read_bounding_boxes_by_node_id(args.bounding_boxes_by_node_id_file)
    nodes = dict(tio.read_node_ids_and_timestamps(args.nodes_by_timestamp_file))
    class_ids = read_class_ids(args.class_ids_file)

    root = Path(args.images_root_directory)
    out_root = Path(args.oa_slam_data_output_directory)
    cam_dirs = sorted(
        [d for d in root.iterdir() if d.is_dir() and d.name.isdigit()]
    )
    if not cam_dirs:
        print("ERROR: no <cam_id> subdirectories under images root",
              file=sys.stderr)
        return 1

    for cam_dir in cam_dirs:
        cam_id = int(cam_dir.name)
        out_cam = out_root / str(cam_id)
        det_dir = out_cam / "detections"
        det_dir.mkdir(parents=True, exist_ok=True)

        frames = sorted(
            int(p.stem) for p in cam_dir.glob("*.png") if p.stem.isdigit()
        )
        with open(out_cam / f"cam_{cam_id}_images.txt", "w") as img_list, open(
            det_dir / "detections.txt", "w"
        ) as det_file:
            for frame_id in frames:
                if frame_id not in nodes:
                    print(
                        f"ERROR: frame {frame_id} missing from "
                        "nodes_by_timestamp_file",
                        file=sys.stderr,
                    )
                    return 1
                rel = f"{cam_id}/{frame_id}.png"
                shutil.copyfile(
                    cam_dir / f"{frame_id}.png", out_cam / f"{frame_id}.png"
                )
                img_list.write(rel + "\n")

                det_file.write("file_name\n")
                det_file.write(rel + "\n")
                det_file.write("detections\n")
                for bb in bbs.get(frame_id, {}).get(cam_id, []):
                    det_file.write("category_id\n")
                    det_file.write(f"{class_ids[bb.semantic_class]}\n")
                    det_file.write("detection_score\n")
                    det_file.write(f"{bb.detection_confidence}\n")
                    det_file.write("bbox\n")
                    c = bb.corners  # [x_min, x_max, y_min, y_max]
                    det_file.write(f"{c[0]},{c[2]},{c[1]},{c[3]}\n")
                det_file.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
