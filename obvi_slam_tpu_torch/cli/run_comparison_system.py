"""Comparison-system launcher — the ROS-free equivalent of the reference's
third-party SLAM orchestration scripts (``run_orb_slam_2.py``,
``run_multi_session_orb_slam_3.py``, ``run_lego_loam.py`` under
src/evaluation/): run a configured third-party SLAM binary
over every session of a sequence, with the same skip/rerun semantics, so its
trajectories can be scored against ours by ``compute_metrics_for_approach``.

Orchestration semantics preserved from the reference
(run_orb_slam_2.py:41-104, run_multi_session_orb_slam_3.py:49-120,
run_lego_loam.py):
  - sessions come from a sequence file; each session gets its own output
    directory named ``{index}_{name}`` under the results root (the ORB-SLAM3
    per-bag layout, which our metrics entry points already consume);
  - a session is SKIPPED when its results already exist and look legitimate
    (expected trajectory file present AND at least ``--min_result_files``
    entries in the directory — the reference's
    minOrbFilesForLegitimateResults guard); ``--force_rerun`` overrides and
    wipes the session directory first;
  - multi-session systems (ORB-SLAM3) chain a map file from session to
    session (``{map_in}``/``{map_out}`` placeholders), mirroring the
    single-process-with-save-points flow;
  - the third-party binary itself is CONFIGURED, not bundled: the reference
    launches ``rosrun ORB_SLAM2 Stereo <vocab> <config> ...`` + a rosbag
    player; without ROS, the equivalent is a command template whose
    placeholders this launcher fills per session.

Command template placeholders: {vocabulary} {config} {session_input}
{output_dir} {name} {index} {map_in} {map_out}.

``--dry_run`` prints the fully-expanded per-session commands without
executing anything (also how the test suite exercises this launcher in an
environment with no third-party SLAM binaries installed).

The port's counterpart of ``cli/run_comparison_system.py``:

    python -m obvi_slam_tpu_torch.cli.run_comparison_system --system_name fake --sequence_file seq.json \\
        --results_root_dir out --command_template "touch {output_dir}/ran_{name}" [--dry_run]
"""

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

FINAL_TRAJECTORY_BASENAME = "trajectory.csv"  # finalTrajectoryFileBaseName


def load_sequence(path):
    """Sequence file: JSON list of session dicts ({name, input...}) — the
    same format cli/sequence_executor.py consumes — or a plain text file of
    one session name per line (the reference's bag-name list)."""
    with open(path) as f:
        text = f.read()
    try:
        sessions = json.loads(text)
        out = []
        for i, s in enumerate(sessions):
            if isinstance(s, str):
                out.append({"name": s})
            else:
                out.append(dict(s))
        return out
    except json.JSONDecodeError:
        return [
            {"name": line.strip()}
            for line in text.splitlines()
            if line.strip() and not line.startswith("#")
        ]


def session_dir(results_root, index, name):
    return Path(results_root) / f"{index}_{name}"


def results_look_legitimate(sdir: Path, min_result_files: int) -> bool:
    """Reference skip logic: output dir exists, holds the expected
    trajectory file, and has enough entries to be a real run."""
    if not sdir.is_dir():
        return False
    if not (sdir / FINAL_TRAJECTORY_BASENAME).exists():
        return False
    return len(os.listdir(sdir)) >= min_result_files


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--system_name", required=True,
                        help="label for logs (orbslam2/orbslam3/legoloam/...)")
    parser.add_argument("--sequence_file", required=True)
    parser.add_argument("--results_root_dir", required=True)
    parser.add_argument(
        "--command_template", required=True,
        help="third-party launch command with {placeholders}; see module doc",
    )
    parser.add_argument("--vocabulary_file", default="")
    parser.add_argument("--configuration_file", default="")
    parser.add_argument(
        "--session_input_root", default="",
        help="per-session inputs live at <root>/<name> unless the sequence "
        "file gives an explicit session_input",
    )
    parser.add_argument(
        "--multi_session_map", action="store_true",
        help="chain {map_in}/{map_out} across sessions (ORB-SLAM3 style)",
    )
    parser.add_argument("--force_rerun", action="store_true")
    parser.add_argument("--min_result_files", type=int, default=2,
                        help="legitimacy threshold for skipping (reference "
                        "uses 20 for ORB-SLAM2's many per-frame files)")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    sessions = load_sequence(args.sequence_file)
    os.makedirs(args.results_root_dir, exist_ok=True)

    prev_map = ""
    rc_final = 0
    for i, session in enumerate(sessions):
        name = session.get("name", f"session_{i}")
        sdir = session_dir(args.results_root_dir, i, name)
        if not args.force_rerun and results_look_legitimate(
            sdir, args.min_result_files
        ):
            print(f"[{args.system_name}] skipping {name}: results exist "
                  "(use --force_rerun to regenerate)", flush=True)
            if args.multi_session_map:
                prev_map = str(sdir / "map.bin")
            continue
        if sdir.is_dir():
            shutil.rmtree(sdir)
        map_out = str(sdir / "map.bin") if args.multi_session_map else ""
        cmd = args.command_template.format(
            vocabulary=args.vocabulary_file,
            config=args.configuration_file,
            session_input=session.get(
                "session_input",
                os.path.join(args.session_input_root, name),
            ),
            output_dir=str(sdir),
            name=name,
            index=i,
            map_in=prev_map,
            map_out=map_out,
        )
        print(f"[{args.system_name}] session {i} ({name}): {cmd}", flush=True)
        if args.dry_run:
            if args.multi_session_map:
                prev_map = map_out
            continue
        sdir.mkdir(parents=True, exist_ok=True)
        result = subprocess.run(shlex.split(cmd))
        if result.returncode != 0:
            print(f"[{args.system_name}] session {name} FAILED "
                  f"(rc={result.returncode})", file=sys.stderr, flush=True)
            rc_final = result.returncode
            break
        if args.multi_session_map:
            prev_map = map_out
    return rc_final


if __name__ == "__main__":
    sys.exit(main())
