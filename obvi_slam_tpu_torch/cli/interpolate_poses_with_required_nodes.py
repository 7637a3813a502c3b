"""Interpolate a timestamped trajectory at required timestamps —
``interpolate_poses_with_required_nodes`` equivalent: linear translation +
quaternion slerp between bracketing poses.

The port's counterpart of ``cli/interpolate_poses_with_required_nodes.py``:

    python -m obvi_slam_tpu_torch.cli.interpolate_poses_with_required_nodes --poses_by_timestamp_file poses.csv \\
        --required_timestamps_file stamps.csv --poses_out_file interp.csv
"""

import argparse
import sys

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--poses_by_timestamp_file", required=True,
                        help="CSV: seconds,nanoseconds,tx,ty,tz,qx,qy,qz,qw (header)")
    parser.add_argument("--required_timestamps_file", required=True,
                        help="CSV: seconds,nanoseconds (header)")
    parser.add_argument("--poses_out_file", required=True)
    args = parser.parse_args(argv)

    def ts(row):
        return float(row[0]) + float(row[1]) * 1e-9

    with open(args.poses_by_timestamp_file) as f:
        rows = [line.split(",") for line in f.read().strip().splitlines()[1:]]
    times = np.array([ts(r) for r in rows])
    order = np.argsort(times)
    times = times[order]
    transl = np.array([[float(rows[i][2]), float(rows[i][3]), float(rows[i][4])] for i in order])
    quats = np.array([[float(rows[i][5]), float(rows[i][6]), float(rows[i][7]), float(rows[i][8])] for i in order])
    slerp = Slerp(times, Rotation.from_quat(quats))

    with open(args.required_timestamps_file) as f:
        req_rows = [line.split(",") for line in f.read().strip().splitlines()[1:]]
    req = [(int(r[0]), int(r[1]), ts(r)) for r in req_rows]

    with open(args.poses_out_file, "w") as f:
        f.write("seconds,nanoseconds,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for sec, nsec, t in req:
            tc = float(np.clip(t, times[0], times[-1]))
            ti = np.interp(tc, times, np.arange(len(times)))
            lo = int(np.floor(ti))
            hi = min(lo + 1, len(times) - 1)
            alpha = ti - lo
            pos = (1 - alpha) * transl[lo] + alpha * transl[hi]
            q = slerp([tc]).as_quat()[0]
            f.write(f"{sec},{nsec},{pos[0]},{pos[1]},{pos[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    print(f"interpolated {len(req)} poses")
    return 0


if __name__ == "__main__":
    sys.exit(main())
