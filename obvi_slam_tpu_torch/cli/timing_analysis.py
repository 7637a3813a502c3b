"""Per-phase runtime breakdown — ``timing_analysis.py`` equivalent
(src/evaluation/timing_analysis.py): reads the timing.json artifacts written
by the main pipeline and prints the online/offline split with per-phase
totals, keyed by the reference-compatible phase names.

The port's counterpart of ``cli/timing_analysis.py``:

    python -m obvi_slam_tpu_torch.cli.timing_analysis timing.json [more timing files]
"""

import argparse
import json
import sys

ONLINE_ROOT = "offline_runner_online_portion"
OFFLINE_ROOT = "offline_runner_offline_portion"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("timing_files", nargs="+")
    args = parser.parse_args(argv)

    totals = {}
    for path in args.timing_files:
        with open(path) as f:
            data = json.load(f)
        for name, stats in data.items():
            agg = totals.setdefault(name, {"total_s": 0.0, "invocations": 0})
            agg["total_s"] += stats["total_s"]
            agg["invocations"] += stats["invocations"]

    online = totals.get(ONLINE_ROOT, {}).get("total_s", 0.0)
    offline = totals.get(OFFLINE_ROOT, {}).get("total_s", 0.0)
    print(f"online portion : {online:10.2f} s")
    print(f"offline portion: {offline:10.2f} s")
    print(f"{'phase':50s} {'total_s':>10s} {'n':>8s} {'mean_ms':>10s}")
    for name, agg in sorted(totals.items(), key=lambda kv: -kv[1]["total_s"]):
        mean_ms = agg["total_s"] / agg["invocations"] * 1e3 if agg["invocations"] else 0
        print(f"{name:50s} {agg['total_s']:10.2f} {agg['invocations']:8d} {mean_ms:10.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
