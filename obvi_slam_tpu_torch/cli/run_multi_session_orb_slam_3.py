"""Multi-session ORB-SLAM3 launcher — preset wrapper over
run_comparison_system.py mirroring the reference's
src/evaluation/run_multi_session_orb_slam_3.py:49-216: per-session
``{index}_{name}`` result dirs, expected-results skip check across the
whole sequence, and the session-to-session map chaining that makes the runs
multi-session ({map_in}/{map_out} placeholders stand in for the reference's
single-process save-points).

The port's counterpart of ``cli/run_multi_session_orb_slam_3.py``:

    python -m obvi_slam_tpu_torch.cli.run_multi_session_orb_slam_3 --orb_slam_vocabulary_file voc.txt \\
        --orb_slam_configuration_file stereo.yaml --sequence_file seq.json \\
        --orb_slam_3_out_root_dir out [--dry_run]
"""

import sys

from obvi_slam_tpu_torch.cli.run_comparison_system import main as generic_main


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--orb_slam_vocabulary_file", required=True)
    parser.add_argument("--orb_slam_configuration_file", required=True)
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument("--orb_slam_3_out_root_dir", required=True)
    parser.add_argument("--session_input_root", default="")
    parser.add_argument(
        "--command_template",
        default="ORB_SLAM3_Stereo {vocabulary} {config} false "
        "{session_input} {output_dir} {map_in} {map_out}",
    )
    parser.add_argument("--force_regenerate_results", action="store_true")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    fwd = [
        "--system_name", "orbslam3",
        "--sequence_file", args.sequence_file,
        "--results_root_dir", args.orb_slam_3_out_root_dir,
        "--command_template", args.command_template,
        "--vocabulary_file", args.orb_slam_vocabulary_file,
        "--configuration_file", args.orb_slam_configuration_file,
        "--session_input_root", args.session_input_root,
        "--multi_session_map",
    ]
    if args.force_regenerate_results:
        fwd.append("--force_rerun")
    if args.dry_run:
        fwd.append("--dry_run")
    return generic_main(fwd)


if __name__ == "__main__":
    sys.exit(main())
