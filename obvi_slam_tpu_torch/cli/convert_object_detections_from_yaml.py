"""Convert annotated object tracks from YAML to the ObjectEst CSV schema —
``convert_object_detections_from_yaml`` equivalent
(reference: src/evaluation/objects/convert_object_detections_from_yaml.cpp,
YAML schema per include/file_io/obj_yaml_reader.h: top-level ``tracks``,
each with a ``track`` list of {label, translation{x,y,z},
rotation{w,x,y,z}, box{length,width,height}}).

Output columns match global_object_estimates_io.h:
semantic_class,transl_x..z,quat_x..w,d_x,d_y,d_z.

The port's counterpart of ``cli/convert_object_detections_from_yaml.py``:

    python -m obvi_slam_tpu_torch.cli.convert_object_detections_from_yaml \\
        --convert_object_detections_from_yaml objs.yaml --obj_output_file_name objs.csv

It needs PyYAML.
"""

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--convert_object_detections_from_yaml", required=True,
                        help="yaml input file")
    parser.add_argument("--obj_output_file_name", required=True,
                        help="csv output file")
    args = parser.parse_args(argv)
    import yaml

    try:
        with open(args.convert_object_detections_from_yaml) as f:
            node = yaml.safe_load(f)
    except (OSError, yaml.YAMLError) as e:
        print(f"WARNING: failed to open/parse yaml: {e}", file=sys.stderr)
        node = {}

    rows = []
    for annotation in (node or {}).get("tracks", []):
        for inst in annotation.get("track", []):
            t = inst["translation"]
            r = inst["rotation"]
            box = inst["box"]
            rows.append(
                [
                    inst["label"],
                    t["x"], t["y"], t["z"],
                    r["x"], r["y"], r["z"], r["w"],
                    # length→d_x, width→d_y, height→d_z (obj_yaml_reader.h)
                    box["length"], box["width"], box["height"],
                ]
            )

    out_dir = os.path.dirname(os.path.abspath(args.obj_output_file_name))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.obj_output_file_name, "w") as f:
        f.write(
            "semantic_class,transl_x,transl_y,transl_z,"
            "quat_x,quat_y,quat_z,quat_w,d_x,d_y,d_z\n"
        )
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
