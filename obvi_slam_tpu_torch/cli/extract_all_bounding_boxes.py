"""Extract bounding boxes for every frame image with a live detector —
the ``extract_all_bounding_boxes.py`` / ``write_bounding_boxes_for_rosbag_
to_file`` equivalent without ROS: instead of replaying a rosbag through the
YOLO service, walks an image directory tree
(``<images_dir>/<camera_id>/<frame_id>.png``) and queries a detector worker
process (see obvi_slam_tpu_torch/frontend/bb_retriever.py for the protocol),
writing the bounding-boxes-by-node-id CSV the main pipeline ingests
(min_x, min_y, max_x, max_y, semantic_class, node_id, camera_id, confidence).

The port's counterpart of ``cli/extract_all_bounding_boxes.py``:

    python -m obvi_slam_tpu_torch.cli.extract_all_bounding_boxes --images_dir images \\
        --detector_command "python detector.py" --output_file bounding_boxes.csv
"""

import argparse
import os
import shlex
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--images_dir", required=True)
    parser.add_argument("--detector_command", required=True)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--img_height", type=int, default=480)
    parser.add_argument("--img_width", type=int, default=640)
    parser.add_argument(
        "--min_confidence", type=float, default=0.0,
        help="drop detections below this confidence",
    )
    args = parser.parse_args(argv)

    from obvi_slam_tpu_torch.frontend.bb_retriever import SubprocessDetectorQuerier

    # Discover <cam>/<frame>.png images.
    frames = {}  # (frame, cam) -> path
    for cam_entry in sorted(os.listdir(args.images_dir)):
        cam_dir = os.path.join(args.images_dir, cam_entry)
        if not (os.path.isdir(cam_dir) and cam_entry.isdigit()):
            continue
        for name in sorted(os.listdir(cam_dir)):
            stem, ext = os.path.splitext(name)
            if ext.lower() in (".png", ".jpg", ".jpeg") and stem.isdigit():
                frames[(int(stem), int(cam_entry))] = os.path.join(cam_dir, name)
    if not frames:
        raise SystemExit(f"no <cam>/<frame>.png images under {args.images_dir}")

    hw = (args.img_height, args.img_width)
    querier = SubprocessDetectorQuerier(
        shlex.split(args.detector_command),
        lambda f, c: (frames[(f, c)], hw) if (f, c) in frames else None,
    )
    n_det = 0
    try:
        os.makedirs(os.path.dirname(os.path.abspath(args.output_file)), exist_ok=True)
        with open(args.output_file, "w") as out:
            out.write(
                "min_pixel_x,min_pixel_y,max_pixel_x,max_pixel_y,"
                "semantic_class,node_id,camera_id,detection_confidence\n"
            )
            for (frame_id, cam_id), _path in sorted(frames.items()):
                bbs = querier.retrieve_bounding_boxes_for_image(frame_id, cam_id)
                for bb in bbs or []:
                    if bb.detection_confidence < args.min_confidence:
                        continue
                    x_min, x_max, y_min, y_max = bb.corners
                    out.write(
                        f"{x_min},{y_min},{x_max},{y_max},"
                        f"{bb.semantic_class},{frame_id},{cam_id},"
                        f"{bb.detection_confidence}\n"
                    )
                    n_det += 1
    finally:
        querier.close()
    print(f"{n_det} detections over {len(frames)} images -> {args.output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
