"""Write a multi-session sequence file — ``sequence_file_writer`` equivalent
(reference: src/data_preprocessing_utils/sequence_file_writer.cpp; JSON
schema per include/file_io/cv_file_storage/sequence_file_storage_io.h and
sequences/evaluation_2023_07_v1.json: {"sequence_info": {"seq_id", "sequence":
[{"bag_base_name", "waypoint_file_base_name": {"has_v", "v"}}]}}).

Unlike the reference (which hard-codes its two bag entries), the entries come
from --bags: a comma-separated list of bag_base_name[:waypoint_file_base_name]
items; omit the waypoint part for a session without waypoints (has_v = 0).

The port's counterpart of ``cli/sequence_file_writer.py``:

    python -m obvi_slam_tpu_torch.cli.sequence_file_writer --sequence_file_directory seqs \\
        --sequence_id seq_v1 --bags bagA:waypoints_A,bagB
"""

import argparse
import json
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence_file_directory", required=True,
                        help="Directory for sequence files")
    parser.add_argument("--sequence_id", required=True,
                        help="Id/name for the sequence")
    parser.add_argument("--bags", required=True,
                        help="comma-separated bag_base_name[:waypoint_file]")
    args = parser.parse_args(argv)

    entries = []
    for item in args.bags.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            bag, wp = item.split(":", 1)
            entries.append(
                {
                    "bag_base_name": bag,
                    "waypoint_file_base_name": {"has_v": 1, "v": wp},
                }
            )
        else:
            entries.append(
                {
                    "bag_base_name": item,
                    "waypoint_file_base_name": {"has_v": 0, "v": ""},
                }
            )

    os.makedirs(args.sequence_file_directory, exist_ok=True)
    out_path = os.path.join(
        args.sequence_file_directory, args.sequence_id + ".json"
    )
    with open(out_path, "w") as f:
        json.dump(
            {
                "sequence_info": {
                    "seq_id": args.sequence_id,
                    "sequence": entries,
                }
            },
            f,
            indent=2,
        )
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
