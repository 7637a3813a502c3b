"""Per-LM-iteration convergence plots from ``ceres_iterations_<type>.csv``
files — the ``iteration_plotter.py`` equivalent
(src/evaluation/iteration_plotter.py): per optimization type, the
distribution of iterations-to-convergence and the cost-change trajectories,
read from the schema optlog.IterationLoggerFactory writes (identical to the
reference's IterationLogger CSVs, optimization_logger.h:29-92).

The port's counterpart of ``cli/iteration_plotter.py``:

    python -m obvi_slam_tpu_torch.cli.iteration_plotter --logs_directory logs --plots_dir plots

It needs matplotlib.
"""

import argparse
import csv
import os
import sys
from collections import defaultdict

ITERATION_LOG_PREFIX = "ceres_iterations_"
ITERATION_FILE_TYPES = [
    "gba_phase_1", "gba_phase_2", "lba_phase_1", "lba_phase_2",
    "pending_obj_est", "pgo", "pre_pgo_track", "vf_adjust",
]


def read_iteration_csv(path):
    """optimization_id -> list of row dicts."""
    out = defaultdict(list)
    with open(path) as f:
        for row in csv.DictReader(f):
            out[row["optimization_id"]].append(
                {
                    "iteration": int(row["iteration_num"]),
                    "cost": float(row["cost"]),
                    "cost_change": float(row["cost_change"]),
                    "step_norm": float(row["step_norm"]),
                    "step_norm_per_param": float(row["step_norm_per_param"]),
                    "success": row["is_successful"] == "1",
                }
            )
    return dict(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--logs_directory", required=True,
        help="directory holding ceres_iterations_<type>.csv files",
    )
    parser.add_argument("--plots_dir", required=True)
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.plots_dir, exist_ok=True)
    made = 0
    for opt_type in ITERATION_FILE_TYPES:
        path = os.path.join(
            args.logs_directory, f"{ITERATION_LOG_PREFIX}{opt_type}.csv"
        )
        if not os.path.exists(path):
            continue
        per_opt = read_iteration_csv(path)
        if not per_opt:
            continue
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        for opt_id, rows in per_opt.items():
            iters = [r["iteration"] for r in rows]
            costs = [r["cost"] for r in rows]
            axes[0].plot(iters, costs, alpha=0.5, linewidth=0.8)
        axes[0].set_yscale("log")
        axes[0].set_xlabel("iteration")
        axes[0].set_ylabel("cost")
        axes[0].set_title(f"{opt_type}: cost per iteration")
        counts = [len(rows) for rows in per_opt.values()]
        axes[1].hist(counts, bins=max(5, min(30, max(counts))))
        axes[1].set_xlabel("iterations to termination")
        axes[1].set_ylabel("solves")
        axes[1].set_title(f"{opt_type}: iterations per solve")
        fig.tight_layout()
        out = os.path.join(args.plots_dir, f"iterations_{opt_type}.png")
        fig.savefig(out, dpi=110)
        plt.close(fig)
        made += 1
        print(f"{opt_type}: {len(per_opt)} solves -> {out}")
    if made == 0:
        print("no ceres_iterations_*.csv files found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
