"""One object-visual SLAM session from files: the port's counterpart of
``cli/offline_object_visual_slam_main.py`` (the reference's
``offline_object_visual_slam_main``).

Reads the config, the calibration, the initial trajectory, the detections,
the ORB feature output and, optionally, a previous session's long-term map
(LTM); runs the sliding-window and global BA loop with the object pipeline
on ``--device``; extracts the LTM; writes the results in the reference's
file formats and names:

    python -m obvi_slam_tpu_torch.cli.offline_object_visual_slam_main \\
        --params_config_file config.json --intrinsics_file intrinsics.csv \\
        --extrinsics_file extrinsics.csv --poses_by_node_id_file poses.csv \\
        --bounding_boxes_by_node_id_file bounding_boxes.csv \\
        --low_level_feats_dir orb_out --robot_poses_results_file out/poses.csv \\
        --long_term_map_output out/ltm.json [--device cpu] [--f64]

Every flag of the reference package's CLI is accepted with its meaning,
except that ``--platform`` is ``--device`` (a torch device, default
``cuda``; with no card the run fails, it never falls back to the CPU).
``--f64`` runs f64 tables (else f32). ``--debug_images_output_directory``
writes one bounding-box-association image per (frame, camera) after each
optimization (``visualization.SaveToFileVisualizer``, its overlays computed
on ``--device``); it needs PIL (Pillow) and exits with a message without
it.

``--shard_devices N`` (N > 1) shards the global-BA solves over N ranks
(``parallel``; ``--shard_local_ba`` the window solves too): one process per
CUDA device over NCCL, or N gloo processes under ``--device cpu``. Started
alone, the entry point launches the N ranks itself (this module again,
with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID`` set at a
free localhost port) and returns the first non-zero exit code of theirs;
started with those variables set (by that launch, or by a launcher of the
user's on several hosts), it is one rank. Every rank runs the session, and
the bounding-box frontend takes rank 0's pending-object estimates; rank 0
writes the outputs. ``--fused_solver off`` takes the runner's host-loop
two-phase branch; ``auto`` and ``on`` its fused one.

The session is built, run and written by ``build_session``, ``run_session``
and ``write_outputs``, which ``main`` composes. The reference's warm-up
thread for the LTM's marginal-covariance program is not ported: it compiles
that program ahead of time for a remote accelerator, and the port compiles
nothing.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from obvi_slam_tpu_torch import config as cfg
from obvi_slam_tpu_torch import parallel
from obvi_slam_tpu_torch import io as oio
from obvi_slam_tpu_torch import optlog
from obvi_slam_tpu_torch.cli._common import check_device, disable_tf32, read_problem_data
from obvi_slam_tpu_torch.frontend import (
    FeatureBasedBoundingBoxFrontEnd,
    apply_merges,
    make_bb_frontend_hook,
    merge_objects_by_center_proximity,
)
from obvi_slam_tpu_torch.ltm import (
    LongTermObjectMap,
    extract_long_term_object_map,
    seed_pose_graph_from_ltm,
)
from obvi_slam_tpu_torch.offline_data import OfflineProblemData
from obvi_slam_tpu_torch.pose_graph import PoseGraph
from obvi_slam_tpu_torch.runner import OfflineProblemRunner, RunnerHooks, visual_frontend_for
from obvi_slam_tpu_torch.timing import TimerRegistry

logger = logging.getLogger("main")

OPT_LOG_HEADER = (
    "frame_id,global_ba,phase,attempt,num_poses,num_features,num_objects,initial_cost,"
    "final_cost,iterations,termination"
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="One object-visual SLAM session from the reference's file formats.")
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--intrinsics_file", required=True)
    parser.add_argument("--extrinsics_file", required=True)
    parser.add_argument("--poses_by_node_id_file", required=True)
    parser.add_argument("--bounding_boxes_by_node_id_file", default="")
    parser.add_argument("--low_level_feats_dir", required=True)
    parser.add_argument("--long_term_map_input", default="")
    parser.add_argument("--long_term_map_output", default="")
    parser.add_argument("--robot_poses_results_file", default="")
    parser.add_argument(
        "--bb_associations_out_file", default="",
        help="bounding-box association results (ObjectDataAssociationResults) as JSON",
    )
    parser.add_argument("--ellipsoids_results_file", default="")
    parser.add_argument("--visual_feature_results_file", default="")
    parser.add_argument("--checkpoint_output_dir", default="")
    parser.add_argument("--logs_directory", default="")
    parser.add_argument("--timing_report_file", default="")
    parser.add_argument("--opt_log_file", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the solves (default cuda; cpu runs on the CPU)")
    parser.add_argument("--f64", action="store_true", help="double-precision solves")
    parser.add_argument(
        "--shard_devices", type=int, default=0,
        help="shard global-BA solves over N ranks, one per CUDA device (gloo processes "
        "under --device cpu); 0 or 1 = one process")
    parser.add_argument("--shard_local_ba", action="store_true",
                        help="also shard sliding-window (local BA) solves over the ranks")
    parser.add_argument(
        "--detector_command", default="",
        help="live detector worker command (newline-delimited JSON {image_path, ...} -> "
        "{detections: [{label, conf, xyxy}]}), for frames absent from "
        "--bounding_boxes_by_node_id_file; requires --images_dir",
    )
    parser.add_argument("--images_dir", default="",
                        help="frame images as <images_dir>/<camera_id>/<frame_id>.png")
    parser.add_argument(
        "--debug_images_output_directory", default="",
        help="write a bounding-box association image per (frame, camera) here (needs PIL)")
    parser.add_argument(
        "--fused_solver", choices=("auto", "on", "off"), default="auto",
        help="two-phase windows as one solve_two_phase call (auto, on) or the host "
        "loop (off)",
    )
    parser.add_argument("--profile_trace_dir", default="",
                        help="write a torch.profiler Chrome trace of the session here")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed flags; exits with a message on a flag whose package is
    missing."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.debug_images_output_directory:
        try:
            import PIL  # noqa: F401
        except ImportError:
            parser.error("--debug_images_output_directory needs the PIL package (Pillow), "
                         "which is not installed")
    if args.detector_command and not args.images_dir:
        parser.error("--detector_command requires --images_dir")
    if args.shard_devices > 1:
        on_cpu = torch.device(args.device).type == "cpu"
        n = (os.cpu_count() or 1) if on_cpu else torch.cuda.device_count()
        if args.shard_devices > n:
            raise SystemExit(f"--shard_devices {args.shard_devices} exceeds the {n} available "
                             f"{'cpu' if on_cpu else 'cuda'} devices")
    return args


def launch_ranks(argv, n: int) -> int:
    """This entry point on ``n`` ranks, each a process of its own meeting at
    a free localhost port; waits for them all and returns the first non-zero
    exit code (every rank is stopped as soon as one fails)."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(n),
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, *argv],
                              env=dict(env, PROCESS_ID=str(r))) for r in range(n)]
    code = 0
    try:
        while any(p.poll() is None for p in procs) and code == 0:
            code = next((p.returncode for p in procs if p.returncode), 0)
            time.sleep(0.1)
        code = code or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return code


@dataclass
class Session:
    """A session built from files, ready to run."""

    args: argparse.Namespace
    config: cfg.FullOVSLAMConfig
    data: OfflineProblemData
    pg: PoseGraph
    bb_frontend: FeatureBasedBoundingBoxFrontEnd
    hooks: RunnerHooks
    runner: OfflineProblemRunner
    visual_frontend: object
    prev_ltm: Optional[LongTermObjectMap]
    querier: object = None
    read_s: float = 0.0  # seconds spent reading the input files


def build_session(args: argparse.Namespace, *, plain: bool = False) -> Session:
    """Reads the inputs and wires the session as the reference's entry point
    does: the pose graph (seeded from ``--long_term_map_input``), the
    feature-based bounding-box frontend on the runner's bb_frontend hook (or
    the live detector's), the checkpoint hook, the post-session merge, the
    runner and the visual frontend. ``plain`` runs every kernel's plain
    PyTorch version (reference runs). Resets the phase timers and the
    optimization logger, which logs to ``--logs_directory`` when given."""
    check_device(args.device)
    dtype = np.float64 if args.f64 else np.float32
    TimerRegistry.instance().reset()
    optlog.IterationLoggerFactory.reset()

    t0 = time.perf_counter()
    config = cfg.read_config(args.params_config_file)
    lt = config.limit_traj_eval_params
    data, img_hw, intrinsics = read_problem_data(
        args, lt.max_frame_id if lt.should_limit_trajectory_evaluation else None
    )
    prev_ltm = (
        LongTermObjectMap.load(args.long_term_map_input) if args.long_term_map_input else None
    )
    read_s = time.perf_counter() - t0
    logger.info(
        "Loaded config %s, %d poses, %d feature tracks, %d frames with detections",
        config.config_version_id, len(data.initial_poses), len(data.feature_tracks),
        len(data.bounding_boxes),
    )

    mesh = None
    if args.shard_devices > 1:
        parallel.initialize_distributed(device=args.device)
        mesh = parallel.make_mesh(device=args.device)
        if mesh.device.type == "cpu":
            # Ranks on one host share its cores: a rank takes its share, or
            # fewer threads where the process was given fewer.
            share = max(1, (os.cpu_count() or 1) // mesh.size)
            torch.set_num_threads(min(share, torch.get_num_threads()))
        if mesh.size != args.shard_devices:
            raise SystemExit(f"--shard_devices {args.shard_devices}: the process group has "
                             f"{mesh.size} ranks")
    pg = PoseGraph(data.cameras, cfg.shape_prior_map(config))
    if prev_ltm is not None:
        seed_pose_graph_from_ltm(pg, prev_ltm)
        logger.info("Seeded %d LTM objects", len(prev_ltm.ellipsoids))
    bb_frontend = FeatureBasedBoundingBoxFrontEnd(
        pg,
        config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params,
        img_heights_and_widths=img_hw,
        ltm_front_end_data=prev_ltm.front_end_data if prev_ltm else None,
        dtype=dtype, device=args.device, plain=plain, mesh=mesh,
    )
    hooks = RunnerHooks(
        bb_frontend=make_bb_frontend_hook(bb_frontend) if data.bounding_boxes else None
    )
    querier = None
    if args.detector_command:
        import shlex

        from obvi_slam_tpu_torch.frontend.bb_retriever import (
            SubprocessDetectorQuerier,
            make_bb_frontend_hook_with_querier,
        )

        def image_provider(frame_id, camera_id):
            path = os.path.join(args.images_dir, str(camera_id), f"{frame_id}.png")
            if not os.path.exists(path):
                return None
            return path, img_hw.get(camera_id, (480, 640))

        querier = SubprocessDetectorQuerier(shlex.split(args.detector_command), image_provider)
        hooks.bb_frontend = make_bb_frontend_hook_with_querier(
            bb_frontend, querier, sorted(intrinsics)
        )
    if args.debug_images_output_directory:
        from obvi_slam_tpu_torch.visualization import (
            SaveToFileVisualizer,
            SaveToFileVisualizerConfig,
        )

        # Both knobs come from feature_based_bb_association_params, as in
        # the reference's wiring (offline_object_visual_slam_main.cpp:823-832).
        fe_params = config.feature_based_bb_association_params
        visualizer = SaveToFileVisualizer(
            args.debug_images_output_directory,
            SaveToFileVisualizerConfig(
                feature_validity_window=fe_params.feature_validity_window,
                bounding_box_inflation_size=fe_params.bounding_box_inflation_size,
            ),
            img_heights_and_widths=img_hw, device=args.device,
        )

        def visualize(p, stage, frame_id):
            # On a mesh the ranks' pose graphs are equal: rank 0 draws.
            if stage == "AFTER_EACH_OPTIMIZATION" and (mesh is None or mesh.rank == 0):
                visualizer.bounding_box_front_end_visualization(p, bb_frontend, frame_id)

        hooks.visualization = visualize
    if args.checkpoint_output_dir:
        os.makedirs(args.checkpoint_output_dir, exist_ok=True)

        def write_checkpoint(p, label):
            path = os.path.join(args.checkpoint_output_dir, label + ".json")
            with open(path, "w") as f:
                json.dump(p.get_state(), f)
            logger.info("Checkpoint written: %s", path)

        hooks.checkpoint = write_checkpoint
    if args.logs_directory:
        optlog.IterationLoggerFactory.instance().set_logging_directory(args.logs_directory)
    merge = config.post_session_object_merge_params
    hooks.object_merger = lambda p: apply_merges(
        p,
        merge_objects_by_center_proximity(p, merge.max_merge_distance, merge.x_y_only_merge),
        bb_frontend,
    )
    runner = OfflineProblemRunner(
        config, hooks, dtype=dtype, device=args.device, plain=plain, mesh=mesh,
        shard_local_ba=args.shard_local_ba,
        use_fused_solver={"auto": None, "on": True, "off": False}[args.fused_solver],
    )
    return Session(
        args=args, config=config, data=data, pg=pg, bb_frontend=bb_frontend, hooks=hooks,
        runner=runner, visual_frontend=visual_frontend_for(runner, data), prev_ltm=prev_ltm,
        querier=querier, read_s=read_s,
    )


def run_session(session: Session) -> bool:
    """``run_optimization`` over the session, under torch.profiler when
    ``--profile_trace_dir`` is given (a Chrome trace, ``trace.json``, with
    the program's spans as ranges ``obvi/<name>`` and their frame ids)."""
    def run():
        return session.runner.run_optimization(
            session.data, session.pg, visual_frontend=session.visual_frontend
        )

    trace_dir = session.args.profile_trace_dir
    if not trace_dir:
        return run()
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(session.args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # Shapes recorded: the spans' ranges (obvi/<name>) carry their frame ids.
    with profile(activities=activities, record_shapes=True) as prof:
        ok = run()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return ok


def _write_state(pg, path):
    with open(path, "w") as f:
        json.dump(pg.get_state(), f)


def write_outputs(session: Session) -> Optional[LongTermObjectMap]:
    """Everything the flags ask for after the run: the pose-graph state
    checkpoints (``pose_graph_state.json``; ``long_term_map_checkpoint.json``
    before the LTM), the LTM (the previous session's on a failed extraction,
    where the config allows), the robot poses, bounding-box associations,
    ellipsoids and visual features, the per-solve log, the timing report and
    the per-iteration CSVs (``ceres_iterations_<type>.csv``). Returns the
    LTM, or None. On a mesh only rank 0 writes (and extracts the LTM)."""
    args, pg, runner = session.args, session.pg, session.runner
    if not runner.is_rank0:
        return None
    if args.checkpoint_output_dir:
        _write_state(pg, os.path.join(args.checkpoint_output_dir, "pose_graph_state.json"))
    ltm = None
    if args.long_term_map_output:
        if args.checkpoint_output_dir:
            _write_state(
                pg, os.path.join(args.checkpoint_output_dir, "long_term_map_checkpoint.json")
            )
        # At the extraction problem's own capacities: the reference passes
        # the session's global pool so that its ahead-of-time compiled
        # program fits, which the port has no need of, and the presized
        # pool would only pad the dense reduced system and its host
        # eigendecomposition (ltm.find_rank_deficiencies).
        ltm = extract_long_term_object_map(
            pg, session.config, session.bb_frontend.get_front_end_obj_map_data(),
            prev_ltm=session.prev_ltm, device=args.device, plain=runner.plain,
        )
        if ltm is not None:
            ltm.save(args.long_term_map_output)
            logger.info("Saved LTM with %d objects to %s", len(ltm.ellipsoids),
                        args.long_term_map_output)
        else:
            logger.error("LTM extraction failed with no fallback")

    if args.robot_poses_results_file:
        oio.write_robot_pose_results(args.robot_poses_results_file, pg)
    if args.bb_associations_out_file:
        oio.write_bb_association_results(args.bb_associations_out_file, pg)
    if args.ellipsoids_results_file:
        oio.write_ellipsoid_results(args.ellipsoids_results_file, pg)
    if args.visual_feature_results_file:
        oio.write_visual_feature_results(args.visual_feature_results_file, pg)
    if args.opt_log_file:
        with open(args.opt_log_file, "w") as f:
            f.write(OPT_LOG_HEADER + "\n")
            for r in runner.opt_log:
                f.write(
                    f"{r.frame_id},{int(r.global_ba)},{r.phase},{r.attempt},"
                    f"{r.num_poses},{r.num_features},{r.num_objects},"
                    f"{r.initial_cost},{r.final_cost},{r.iterations},{r.termination}\n"
                )
    if args.timing_report_file:
        with open(args.timing_report_file, "w") as f:
            json.dump(TimerRegistry.instance().summary(), f, indent=1)
    optlog.IterationLoggerFactory.instance().write_all()
    return ltm


def _log_to(logs_directory):
    """INFO logging to ``<logs_directory>/obvi_slam_tpu.log`` (else to
    stderr). Returns a function that undoes it."""
    fmt = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
    if not logs_directory:
        logging.basicConfig(level=logging.INFO, format=fmt)
        return lambda: None
    os.makedirs(logs_directory, exist_ok=True)
    handler = logging.FileHandler(os.path.join(logs_directory, "obvi_slam_tpu.log"))
    handler.setFormatter(logging.Formatter(fmt))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)

    def undo():
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()

    return undo


def main(argv=None) -> int:
    t_start = time.time()
    args = parse_args(argv)
    if args.shard_devices > 1 and "COORDINATOR_ADDRESS" not in os.environ:
        return launch_ranks(sys.argv[1:] if argv is None else list(argv), args.shard_devices)
    disable_tf32()
    undo_logging = _log_to(args.logs_directory)
    try:
        session = build_session(args)
        try:
            ok = run_session(session)
        finally:
            if session.querier is not None:
                session.querier.close()
        if not ok:
            logger.error("Optimization failed")
            return 1
        write_outputs(session)
        pg = session.pg
        logger.info("Session complete: %d frames, %d features, %d objects in %.1fs",
                    len(pg.robot_poses), len(pg.features), len(pg.objects),
                    time.time() - t_start)
    finally:
        optlog.IterationLoggerFactory.reset()
        undo_logging()
        if args.shard_devices > 1 and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(
        f"frames={len(pg.robot_poses)} features={len(pg.features)} "
        f"objects={len(pg.objects)} wall={time.time() - t_start:.1f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
