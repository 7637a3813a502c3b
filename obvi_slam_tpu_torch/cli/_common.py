"""What the port's entry points share: full-precision matmuls, the device
check and the session inputs read from the reference's file formats."""

from __future__ import annotations

from typing import Optional

import torch

from obvi_slam_tpu_torch import io as oio
from obvi_slam_tpu_torch.io.readers import make_cameras
from obvi_slam_tpu_torch.offline_data import OfflineProblemData


def disable_tf32():
    """f32 matmuls and convolutions at full precision: the solver leaves
    TF32 to the caller, and TF32's 10-bit mantissa would break the f32 step's
    accuracy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_device(device: str):
    """Exits with a message when ``device`` is a CUDA device and there is
    none: the entry points never fall back to the CPU on their own."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {device}: no CUDA device is available (pass --device cpu to run "
            "on the CPU)"
        )


def read_cameras(intrinsics_file: str, extrinsics_file: str):
    """(cameras, img (height, width) by camera, intrinsics by camera)."""
    intrinsics = oio.read_camera_intrinsics(intrinsics_file)
    extrinsics = oio.read_camera_extrinsics(extrinsics_file)
    cameras, img_hw = make_cameras(intrinsics, extrinsics)
    return cameras, img_hw, intrinsics


def read_problem_data(args, max_frame_id: Optional[int] = None):
    """The session's OfflineProblemData from the files that ``args`` names
    (calibration, initial poses, optional detections, ORB output), the ORB
    tracks cut at ``max_frame_id``; also the image sizes and intrinsics by
    camera."""
    cameras, img_hw, intrinsics = read_cameras(args.intrinsics_file, args.extrinsics_file)
    initial_poses = oio.read_poses_by_node_id(args.poses_by_node_id_file)
    bounding_boxes = (
        oio.read_bounding_boxes_by_node_id(args.bounding_boxes_by_node_id_file)
        if args.bounding_boxes_by_node_id_file
        else {}
    )
    tracks, init_positions = oio.read_orb_output_directory(
        args.low_level_feats_dir, max_frame_id=max_frame_id
    )
    data = OfflineProblemData(
        cameras=cameras,
        feature_tracks=tracks,
        feature_init_positions=init_positions,
        initial_poses=initial_poses,
        bounding_boxes=bounding_boxes,
    )
    return data, img_hw, intrinsics
