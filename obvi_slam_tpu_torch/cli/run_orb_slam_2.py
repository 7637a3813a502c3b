"""ORB-SLAM2 sequence launcher — preset wrapper over
run_comparison_system.py mirroring the reference's
src/evaluation/run_orb_slam_2.py:86-157 (per-bag output dirs, vocabulary +
stereo config, skip-unless-force with the 20-file legitimacy guard). The
binary is configured with --command_template because this environment has
no ROS/ORB-SLAM2 install; the default template matches the reference's
``rosrun ORB_SLAM2 Stereo <vocab> <config> false <outdir>`` argument order
with the rosbag player replaced by a {session_input} argument.

The port's counterpart of ``cli/run_orb_slam_2.py``:

    python -m obvi_slam_tpu_torch.cli.run_orb_slam_2 --orb_slam_vocabulary_file voc.txt \\
        --orb_slam_configuration_file stereo.yaml --sequence_file seq.json \\
        --orb_slam_2_out_root_dir out [--dry_run]
"""

import sys

from obvi_slam_tpu_torch.cli.run_comparison_system import main as generic_main


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--orb_slam_vocabulary_file", required=True)
    parser.add_argument("--orb_slam_configuration_file", required=True)
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument("--orb_slam_2_out_root_dir", required=True)
    parser.add_argument("--session_input_root", default="")
    parser.add_argument(
        "--command_template",
        default="ORB_SLAM2_Stereo {vocabulary} {config} false {output_dir} "
        "{session_input}",
    )
    parser.add_argument("--force_run_orb_slam_2", action="store_true")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    fwd = [
        "--system_name", "orbslam2",
        "--sequence_file", args.sequence_file,
        "--results_root_dir", args.orb_slam_2_out_root_dir,
        "--command_template", args.command_template,
        "--vocabulary_file", args.orb_slam_vocabulary_file,
        "--configuration_file", args.orb_slam_configuration_file,
        "--session_input_root", args.session_input_root,
        "--min_result_files", "20",
    ]
    if args.force_run_orb_slam_2:
        fwd.append("--force_rerun")
    if args.dry_run:
        fwd.append("--dry_run")
    return generic_main(fwd)


if __name__ == "__main__":
    sys.exit(main())
