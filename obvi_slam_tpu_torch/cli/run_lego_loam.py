"""LeGO-LOAM sequence launcher — preset wrapper over
run_comparison_system.py mirroring the reference's
src/evaluation/run_lego_loam.py (per-bag LiDAR SLAM runs feeding the
lego-loam trajectory comparisons). No vocabulary/config pair — the command
template takes the session input and output directory directly.

The port's counterpart of ``cli/run_lego_loam.py``:

    python -m obvi_slam_tpu_torch.cli.run_lego_loam --sequence_file seq.json --lego_loam_out_root_dir out [--dry_run]
"""

import sys

from obvi_slam_tpu_torch.cli.run_comparison_system import main as generic_main


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument("--lego_loam_out_root_dir", required=True)
    parser.add_argument("--session_input_root", default="")
    parser.add_argument(
        "--command_template",
        default="lego_loam_runner {session_input} {output_dir}",
    )
    parser.add_argument("--force_rerun", action="store_true")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    fwd = [
        "--system_name", "legoloam",
        "--sequence_file", args.sequence_file,
        "--results_root_dir", args.lego_loam_out_root_dir,
        "--command_template", args.command_template,
        "--session_input_root", args.session_input_root,
    ]
    if args.force_rerun:
        fwd.append("--force_rerun")
    if args.dry_run:
        fwd.append("--dry_run")
    return generic_main(fwd)


if __name__ == "__main__":
    sys.exit(main())
