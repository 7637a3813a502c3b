"""Shared helpers of the tests that hold the port's command-line entry
points against the JAX package on the CPU at f64: sessions exported in the
reference's file formats, the port's CLI flags for them, the JAX package's
session wired in process as its ``cli/offline_object_visual_slam_main.py``
wires it (on the files, through its own readers), and the CSV outputs
parsed for comparison."""

import json
import os
from pathlib import Path

import numpy as np

from obvi_slam_tpu import config as jcfg
from obvi_slam_tpu import io as jio
from obvi_slam_tpu import optlog as joptlog
from obvi_slam_tpu import runner as jrunner
from obvi_slam_tpu.frontend import FeatureBasedBoundingBoxFrontEnd as JaxBbFrontEnd
from obvi_slam_tpu.frontend import VisualFeatureFrontend as JaxVisualFrontend
from obvi_slam_tpu.frontend import apply_merges as jax_apply_merges
from obvi_slam_tpu.frontend import make_bb_frontend_hook as jax_bb_hook
from obvi_slam_tpu.frontend import merge_objects_by_center_proximity as jax_merges
from obvi_slam_tpu.io.readers import make_cameras as jax_make_cameras
from obvi_slam_tpu.ltm import extract_long_term_object_map as jax_extract
from obvi_slam_tpu.offline_data import OfflineProblemData as JaxData
from obvi_slam_tpu.pose_graph import PoseGraph as JaxPoseGraph
from obvi_slam_tpu.timing import TimerRegistry as JaxTimers
from obvi_slam_tpu_torch.synthetic import export_session_files

# Output flags of the main entry point and their file names in ``out``.
OUTPUTS = {
    "--long_term_map_output": "ltm.json",
    "--robot_poses_results_file": "robot_poses.csv",
    "--ellipsoids_results_file": "ellipsoids.csv",
    "--visual_feature_results_file": "features.csv",
    "--opt_log_file": "ceres_opt_summary.csv",
    "--timing_report_file": "timing.json",
    "--bb_associations_out_file": "bb_assoc.json",
    "--checkpoint_output_dir": "checkpoints",
    "--logs_directory": "logs",
}
CHECKPOINTS = ("pose_graph_state_checkpoint_post_frame_add.json",
               "pose_graph_state_checkpoint_post_postprocessing.json",
               "long_term_map_checkpoint.json", "pose_graph_state.json")


def export(data, gt, d: Path, config, detections=True):
    """The session's files and its config (``config.json``, a JAX package
    config written by its ``write_config``) in ``d``; without
    ``detections`` the bounding-box file is removed (a visual-only
    session)."""
    export_session_files(data, gt, d)
    if not detections:
        (d / "bounding_boxes.csv").unlink()
    jcfg.write_config(config, str(d / "config.json"))
    return d


def input_args(d: Path):
    args = [
        "--params_config_file", str(d / "config.json"),
        "--intrinsics_file", str(d / "intrinsics.csv"),
        "--extrinsics_file", str(d / "extrinsics.csv"),
        "--poses_by_node_id_file", str(d / "poses.csv"),
        "--low_level_feats_dir", str(d / "orb_out"),
    ]
    if (d / "bounding_boxes.csv").exists():
        args += ["--bounding_boxes_by_node_id_file", str(d / "bounding_boxes.csv")]
    return args


def cli_args(d: Path, out: Path, *extra):
    """The port CLI's argv on the CPU at f64 with every output flag set."""
    args = input_args(d) + ["--device", "cpu", "--f64"]
    for flag, name in OUTPUTS.items():
        args += [flag, str(out / name)]
    return args + list(extra)


def jax_files_session(d: Path, out: Path, recorder_cls=None, **runner_kw):
    """The JAX package's session on the files in ``d``, wired in process as
    its ``cli/offline_object_visual_slam_main.py`` wires it (the fused
    branch unless ``runner_kw`` says otherwise, no device sync), with the
    same outputs into ``out``. ``recorder_cls(runner)`` (e.g.
    ``SolveRecorder``) records its solves, the mini-BA's too. Returns
    (runner, pose graph, recorder or None)."""
    from obvi_slam_tpu import solver as jsolver

    config = jcfg.read_config(str(d / "config.json"))
    cameras, img_hw = jax_make_cameras(jio.read_camera_intrinsics(str(d / "intrinsics.csv")),
                                       jio.read_camera_extrinsics(str(d / "extrinsics.csv")))
    poses = jio.read_poses_by_node_id(str(d / "poses.csv"))
    bbs_file = d / "bounding_boxes.csv"
    bbs = jio.read_bounding_boxes_by_node_id(str(bbs_file)) if bbs_file.exists() else {}
    tracks, init = jio.read_orb_output_directory(str(d / "orb_out"))
    data = JaxData(cameras=cameras, feature_tracks=tracks, feature_init_positions=init,
                   initial_poses=poses, bounding_boxes=bbs)
    pg = JaxPoseGraph(cameras, jcfg.shape_prior_map(config))
    fe = JaxBbFrontEnd(pg, config.feature_based_bb_association_params,
                       config.bounding_box_covariance_generator_params,
                       config.geometric_similarity_scorer_params, img_heights_and_widths=img_hw)
    ckpt = out / "checkpoints"
    ckpt.mkdir(parents=True, exist_ok=True)

    def write_state(p, label):
        with open(ckpt / f"{label}.json", "w") as f:
            json.dump(p.get_state(), f)

    merge = config.post_session_object_merge_params
    hooks = jrunner.RunnerHooks(
        bb_frontend=jax_bb_hook(fe) if bbs else None, checkpoint=write_state,
        object_merger=lambda p: jax_apply_merges(
            p, jax_merges(p, merge.max_merge_distance, merge.x_y_only_merge), fe),
    )
    runner = jrunner.OfflineProblemRunner(
        config, hooks, **dict(dict(use_fused_solver=True, use_device_sync=False), **runner_kw))
    recorder = recorder_cls(runner) if recorder_cls else None
    vp = config.visual_feature_params
    max_frame = max(poses)
    vf = JaxVisualFrontend(
        gba_checker=lambda f: runner._gba_checker(f, max_frame),
        reprojection_error_provider=lambda *a: vp.reprojection_error_std_dev,
        min_parallax_pixel=vp.min_visual_feature_parallax_pixel_requirement,
        min_parallax_transl=vp.min_visual_feature_parallax_robot_transl_requirement,
        min_parallax_orient=vp.min_visual_feature_parallax_robot_orient_requirement,
        enforce_pixel_parallax=vp.enforce_min_pixel_parallax_requirement,
        enforce_pose_parallax=vp.enforce_min_robot_pose_parallax_requirement,
        inlier_epipolar_err_thresh=vp.inlier_epipolar_err_thresh,
        check_past_n_frames=vp.check_past_n_frames_for_epipolar_err,
        enforce_epipolar=vp.enforce_epipolar_error_requirement,
    )
    JaxTimers.instance().reset()
    ilf = joptlog.IterationLoggerFactory.instance()
    ilf.set_logging_directory(str(out / "logs"))
    host_solve = jsolver.solve
    if recorder is not None:
        jsolver.solve = recorder.mini_ba
    try:
        assert runner.run_optimization(data, pg, visual_frontend=vf)
        write_state(pg, "pose_graph_state")
        write_state(pg, "long_term_map_checkpoint")
        ltm = jax_extract(pg, config, fe.get_front_end_obj_map_data(),
                          caps=runner.caps_pool("global"))
        ltm.save(str(out / "ltm.json"))
        ilf.write_all()
    finally:
        jsolver.solve = host_solve
        joptlog.IterationLoggerFactory.reset()
    jio.write_robot_pose_results(str(out / "robot_poses.csv"), pg)
    jio.write_ellipsoid_results(str(out / "ellipsoids.csv"), pg)
    jio.write_visual_feature_results(str(out / "features.csv"), pg)
    jio.write_bb_association_results(str(out / "bb_assoc.json"), pg)
    with open(out / "ceres_opt_summary.csv", "w") as f:
        f.write("frame_id,global_ba,phase,attempt,num_poses,num_features,num_objects,"
                "initial_cost,final_cost,iterations,termination\n")
        for r in runner.opt_log:
            f.write(f"{r.frame_id},{int(r.global_ba)},{r.phase},{r.attempt},{r.num_poses},"
                    f"{r.num_features},{r.num_objects},{r.initial_cost},{r.final_cost},"
                    f"{r.iterations},{r.termination}\n")
    with open(out / "timing.json", "w") as f:
        json.dump(JaxTimers.instance().summary(), f, indent=1)
    return runner, pg, recorder


def csv_rows(path):
    """(header, rows as lists of strings) of a CSV file."""
    lines = Path(path).read_text().strip().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


def csv_floats(path, columns=None):
    """The CSV's rows as a float array (all columns, or ``columns``)."""
    _, rows = csv_rows(path)
    if columns is not None:
        rows = [np.atleast_1d(np.array(r, dtype=object)[columns]) for r in rows]
    return np.array([[float(v) for v in r] for r in rows])


def iteration_csvs(logs: Path):
    return {p.name: csv_rows(p) for p in sorted(Path(logs).glob("ceres_iterations_*.csv"))}


def checkpoint_names(out: Path):
    return sorted(os.listdir(out / "checkpoints"))
