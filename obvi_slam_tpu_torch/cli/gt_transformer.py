"""Transform a (pseudo) ground-truth trajectory from its sensor frame to the
base_link frame and re-anchor it at the origin — ``gt_transformer``
equivalent (reference: src/evaluation/gt_transformer.cpp:202-267).

Reads a timestamped trajectory (e.g. interpolated LeGO-LOAM output expressed
in the lidar frame), composes each pose with the inverse of the
sensor-to-base_link extrinsic (combinePoses(gt_pose, inverse(extrinsic)),
gt_transformer.cpp:239-242), shifts the whole trajectory so it starts at the
origin (adjustTrajectoryToStartAtOrigin), and writes the calibrated
timestamped trajectory.

The port's counterpart of ``cli/gt_transformer.py``:

    python -m obvi_slam_tpu_torch.cli.gt_transformer --interpolated_traj interp.csv \\
        --lego_loam_frame_to_bl_extrinsics lego_loam_bl.csv --interp_out_file gt.csv
"""

import argparse
import sys

import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu_torch.io import timestamped as tio


def _rt(pose):
    return Rotation.from_rotvec(pose[3:6]).as_matrix(), pose[:3]


def _pose(R, t):
    return np.concatenate([t, Rotation.from_matrix(R).as_rotvec()])


def combine(a, b):
    """combinePoses: pose of (frame of b composed into frame of a)."""
    Ra, ta = _rt(a)
    Rb, tb = _rt(b)
    return _pose(Ra @ Rb, Ra @ tb + ta)


def inverse(p):
    R, t = _rt(p)
    return _pose(R.T, -R.T @ t)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--interpolated_traj", required=True,
                        help="timestamped trajectory CSV in the GT sensor frame")
    parser.add_argument("--lego_loam_frame_to_bl_extrinsics", required=True,
                        help="CSV tx,ty,tz,qx,qy,qz,qw (header): pose of the "
                             "GT sensor frame relative to base_link")
    parser.add_argument("--interp_out_file", required=True)
    args = parser.parse_args(argv)

    traj = tio.read_poses_with_timestamps(args.interpolated_traj)
    if not traj:
        print("ERROR: empty input trajectory", file=sys.stderr)
        return 1

    with open(args.lego_loam_frame_to_bl_extrinsics) as f:
        rows = [ln.split(",") for ln in f.read().strip().splitlines()[1:]
                if ln.strip()]
    if not rows:
        print("ERROR: GT trajectory extrinsics missing", file=sys.stderr)
        return 1
    if len(rows) > 1:
        print(
            "WARNING: extrinsics file contained more than one pose; "
            "taking the first",
            file=sys.stderr,
        )
    vals = [float(v) for v in rows[0][:7]]
    extr = tio.pose7_from_transl_quat(vals[0:3], vals[3:7])
    extr_inv = inverse(extr)

    calibrated = [combine(pose, extr_inv) for _, pose in traj]

    # adjustTrajectoryToStartAtOrigin: express every pose relative to the
    # first one.
    first_inv = inverse(calibrated[0])
    adjusted = [combine(first_inv, p) for p in calibrated]

    tio.write_poses_with_timestamps(
        args.interp_out_file,
        [(ts, pose) for (ts, _), pose in zip(traj, adjusted)],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
