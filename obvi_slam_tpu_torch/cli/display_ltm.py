"""Inspect a long-term object map — ``display_ltm`` equivalent (text dump
instead of RViz).

The port's counterpart of ``cli/display_ltm.py``:

    python -m obvi_slam_tpu_torch.cli.display_ltm ltm.json [--covariances]
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ltm_file")
    parser.add_argument("--covariances", action="store_true")
    args = parser.parse_args(argv)

    from obvi_slam_tpu_torch.ltm import LongTermObjectMap

    ltm = LongTermObjectMap.load(args.ltm_file)
    print(f"Long-term map: {len(ltm.ellipsoids)} objects")
    for obj_id in sorted(ltm.ellipsoids):
        cls, e = ltm.ellipsoids[obj_id]
        print(
            f"  obj {obj_id:4d} [{cls:12s}] center=({e[0]:8.3f},{e[1]:8.3f},{e[2]:8.3f}) "
            f"yaw={e[3]:7.3f} dims=({e[4]:.3f},{e[5]:.3f},{e[6]:.3f})"
        )
        if args.covariances and obj_id in ltm.covariances:
            std = np.sqrt(np.maximum(np.diag(ltm.covariances[obj_id]), 0))
            print(f"            std: {np.array2string(std, precision=3)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
