"""Visualization artifact dumps: counterpart of ``obvi_slam_tpu/visualization.py``
(the reference's RViz-free side-car: ``ros_visualization.h`` topics and
``save_to_file_visualizer.h`` debug image dumps).

  - ``plot_topdown_trajectory``, ``plot_iteration_costs``,
    ``plot_waypoint_cdfs``, ``plot_feature_cloud``: matplotlib figures
    (Agg backend, matplotlib imported inside each function);
  - ``SaveToFileVisualizer``: one bounding-box-association debug image per
    (frame, camera). Its overlays (each object's predicted box through the
    dual-quadric corner math, each feature's reprojection) are computed for
    the whole frame in one batched torch call on the visualizer's device and
    read back once (``frame_overlays``); PIL then draws them on the host
    (``draw``), in the reference's order and colours.

matplotlib and PIL are imported only by the functions that draw.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from obvi_slam_tpu_torch import geometry as geo


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ensure(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def plot_topdown_trajectory(
    path: str,
    trajectories: Dict[str, np.ndarray],
    objects: Optional[Dict[int, tuple]] = None,
    gt_objects: Optional[Dict[int, tuple]] = None,
    title: str = "top-down trajectory",
):
    """Top-down (x-y) plot of one or more trajectories + ellipsoid footprints.

    ``trajectories``: label -> (N, 6) raw poses (NaN rows = lost).
    ``objects`` / ``gt_objects``: obj_id -> (class, 7-vec ellipsoid).
    """
    plt = _pyplot()
    from matplotlib.patches import Ellipse

    _ensure(path)
    fig, ax = plt.subplots(figsize=(9, 9))
    for label, traj in trajectories.items():
        ax.plot(traj[:, 0], traj[:, 1], label=label, linewidth=1.2)
        ok = ~np.any(np.isnan(traj), axis=1)
        if ok.any():
            ax.plot(traj[ok, 0][0], traj[ok, 1][0], "o", markersize=6)

    def draw_objects(objs, color, label):
        first = True
        for obj_id, (cls, e) in objs.items():
            ell = Ellipse(
                (e[0], e[1]),
                width=e[4],
                height=e[5],
                angle=np.degrees(e[3]),
                fill=False,
                edgecolor=color,
                linewidth=1.5,
                label=label if first else None,
            )
            ax.add_patch(ell)
            ax.annotate(f"{obj_id}", (e[0], e[1]), fontsize=7, color=color)
            first = False

    if objects:
        draw_objects(objects, "tab:red", "objects (est)")
    if gt_objects:
        draw_objects(gt_objects, "tab:green", "objects (gt)")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)


def plot_iteration_costs(path: str, opt_log, title: str = "per-solve costs"):
    """Per-solve initial/final costs over frames (iteration_plotter analog).
    ``opt_log``: list of runner.OptLogRecord."""
    plt = _pyplot()
    _ensure(path)
    fig, ax = plt.subplots(figsize=(10, 5))
    frames = [r.frame_id for r in opt_log]
    ax.semilogy(frames, [max(r.initial_cost, 1e-12) for r in opt_log], ".", label="initial",
                alpha=0.6)
    ax.semilogy(frames, [max(r.final_cost, 1e-12) for r in opt_log], ".", label="final",
                alpha=0.6)
    ax.set_xlabel("frame")
    ax.set_ylabel("cost")
    ax.legend()
    ax.set_title(title)
    ax.grid(alpha=0.3)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)


def plot_waypoint_cdfs(
    path: str,
    transl_devs_by_approach: Dict[str, List[float]],
    rot_devs_by_approach: Optional[Dict[str, List[float]]] = None,
):
    """Waypoint-consistency CDFs (waypoint_consistency_cdf_plotter analog)."""
    plt = _pyplot()
    _ensure(path)
    n_plots = 2 if rot_devs_by_approach else 1
    fig, axes = plt.subplots(1, n_plots, figsize=(6 * n_plots, 5), squeeze=False)
    ax = axes[0, 0]
    for label, devs in transl_devs_by_approach.items():
        if not devs:
            continue
        x = np.sort(devs)
        y = np.arange(1, len(x) + 1) / len(x)
        ax.plot(x, y, label=label)
    ax.set_xlabel("translation deviation [m]")
    ax.set_ylabel("proportion")
    ax.legend()
    ax.grid(alpha=0.3)
    if rot_devs_by_approach:
        ax2 = axes[0, 1]
        for label, devs in rot_devs_by_approach.items():
            if not devs:
                continue
            x = np.degrees(np.sort(devs))
            y = np.arange(1, len(x) + 1) / len(x)
            ax2.plot(x, y, label=label)
        ax2.set_xlabel("orientation deviation [deg]")
        ax2.set_ylabel("proportion")
        ax2.legend()
        ax2.grid(alpha=0.3)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)


def plot_feature_cloud(path: str, points: np.ndarray, trajectory=None, title="features"):
    """3-D feature cloud + trajectory (RViz feature-cloud topic analog)."""
    plt = _pyplot()
    _ensure(path)
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=2, alpha=0.5)
    if trajectory is not None:
        ax.plot(trajectory[:, 0], trajectory[:, 1], trajectory[:, 2], "r-", linewidth=2)
    ax.set_title(title)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# Per-frame debug image dumps: SaveToFileVisualizer
# (save_to_file_visualizer.h:26-116 + debugging_image_utils.h), headless.


def _bb_color_table():
    """Reference colors (save_to_file_visualizer.h:36-45): associated = red,
    pending = (186, 0, 247); inflated variants are the same colors
    brightened by 0.3."""

    def brighten(c, amount=0.3):
        return tuple(int(v + (255 - v) * amount) for v in c)

    assoc = (255, 0, 0)
    pending = (186, 0, 247)
    return {
        "associated": assoc,
        "associated_inflated": brighten(assoc),
        "pending": pending,
        "pending_inflated": brighten(pending),
        "predicted": (0, 200, 0),
        "feature": (255, 255, 0),
        "feature_reproj": (0, 255, 255),
    }


class SaveToFileVisualizerConfig:
    """SaveToFileBbFrontEndVisualizerConfig (save_to_file_visualizer.h:17-24)."""

    def __init__(
        self, feature_validity_window: int = 2**31 - 1,
        bounding_box_inflation_size: float = 0.0,
    ):
        self.feature_validity_window = feature_validity_window
        self.bounding_box_inflation_size = bounding_box_inflation_size


@dataclass
class FrameOverlays:
    """What one frame's debug images show, per camera in drawing order.

    ``assoc``: (camera, corners, object id) of the pose graph's observations
    at the frame; ``pending``: (camera, corners) of the frontend's pending
    objects' observations at it; ``feats``: (camera, pixel, feature id) of
    the visual factors within the validity window; ``predicted``: (camera,
    object id, pixel box [x_min, x_max, y_min, y_max]) of every object whose
    centre lies in front of the camera and whose corner math is valid, in
    ``pg.objects`` order; ``reprojections[i]``: the reprojected pixel of
    ``feats[i]`` (None when not drawn: no pose, no reprojections asked, an
    unknown feature or a point at or behind the camera)."""

    frame_id: int
    cam_ids: List[int]
    assoc: List[Tuple[int, np.ndarray, int]] = field(default_factory=list)
    pending: List[Tuple[int, np.ndarray]] = field(default_factory=list)
    feats: List[Tuple[int, np.ndarray, int]] = field(default_factory=list)
    predicted: List[Tuple[int, int, np.ndarray]] = field(default_factory=list)
    reprojections: List[Optional[np.ndarray]] = field(default_factory=list)

    def count(self) -> int:
        """Overlays computed: boxes, feature dots and reprojections."""
        return (len(self.assoc) + len(self.pending) + len(self.feats) + len(self.predicted)
                + sum(r is not None for r in self.reprojections))


class SaveToFileVisualizer:
    """Dump per-(frame, camera) bounding-box-association debug images.

    Drawn per image (boundingBoxFrontEndVisualization's content,
    save_to_file_visualizer.h:48-116):
      - associated bbs (red) = object-observation factors in the pose graph,
        labeled with their object id, plus the inflated box when
        ``bounding_box_inflation_size`` > 0 (brightened color);
      - pending bbs (purple) = observations of not-yet-initialized objects
        from the bb frontend;
      - predicted bbs (green) = current ellipsoid estimates projected through
        the dual-quadric corner math;
      - visual features observed within ``feature_validity_window`` frames
        (yellow dots) and, optionally, their reprojections through the
        current pose/point estimates (cyan).

    ``image_provider(frame_id, cam_id) -> np.ndarray | PIL.Image | None``
    supplies real camera images when available; otherwise a neutral canvas of
    ``img_heights_and_widths`` is used. The overlays are computed on
    ``device`` in f64.
    """

    def __init__(
        self,
        output_directory: str,
        config: SaveToFileVisualizerConfig = None,
        image_provider=None,
        img_heights_and_widths: Optional[Dict[int, tuple]] = None,
        device="cuda",
    ):
        self.out_dir = output_directory
        self.config = config or SaveToFileVisualizerConfig()
        self.image_provider = image_provider
        self.img_hw = img_heights_and_widths or {}
        self.colors = _bb_color_table()
        self.device = torch.device(device)
        if output_directory:
            os.makedirs(output_directory, exist_ok=True)

    # -- overlays -----------------------------------------------------------
    def frame_overlays(
        self, pg, bb_frontend, frame_id, draw_feature_reprojections: bool = True
    ) -> Optional[FrameOverlays]:
        """The frame's overlays (None when no camera saw anything at it): the
        predicted boxes of every (camera, object) pair and the feature
        reprojections in one batched computation on the device, read back
        once."""
        cam_ids = set()
        ov = FrameOverlays(frame_id, [])
        for f in pg.object_observations:
            if f.frame_id == frame_id:
                cam_ids.add(f.camera_id)
                ov.assoc.append((f.camera_id, f.corners, f.object_id))
        if bb_frontend is not None:
            for pend in getattr(bb_frontend, "pending", []):
                for obs in pend.observations:
                    if obs.frame_id == frame_id:
                        cam_ids.add(obs.camera_id)
                        ov.pending.append((obs.camera_id, obs.corners))
        lo = max(0, frame_id - self.config.feature_validity_window)
        for past_frame in range(lo, frame_id + 1):
            for fac_idx in pg.visual_factors_by_frame.get(past_frame, []):
                f = pg.visual_factors[fac_idx]
                cam_ids.add(f.camera_id)
                ov.feats.append((f.camera_id, f.pixel, f.feature_id))
        if not cam_ids:
            return None
        ov.cam_ids = sorted(cam_ids)
        ov.reprojections = [None] * len(ov.feats)
        pose = pg.get_robot_pose(frame_id)
        if pose is None:
            return ov

        cams = ov.cam_ids
        cam_row = {c: i for i, c in enumerate(cams)}
        k = np.stack([pg.cameras[c].intrinsics for c in cams])
        ext_r = np.stack([pg.cameras[c].extrinsics_r for c in cams])
        ext_t = np.stack([pg.cameras[c].extrinsics_t for c in cams])
        # The robot in each camera's frame: the extrinsics' inverse.
        r_cr = np.swapaxes(ext_r, -1, -2)
        t_cr = -np.einsum("cij,cj->ci", r_cr, ext_t)
        obj_ids = list(pg.objects)
        ellipsoids = np.array([pg.objects[o].ellipsoid for o in obj_ids]).reshape(-1, 7)
        reproj_rows = []
        if draw_feature_reprojections:
            reproj_rows = [i for i, (_, _, feat_id) in enumerate(ov.feats)
                           if pg.features.get(feat_id) is not None]
        points = np.array([pg.features[ov.feats[i][2]] for i in reproj_rows]).reshape(-1, 3)
        feat_cam = np.array([cam_row[ov.feats[i][0]] for i in reproj_rows], dtype=np.int64)

        packed = _overlay_math(
            *(torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)
              for x in (pose, ellipsoids, k, r_cr, t_cr, points)),
            torch.as_tensor(feat_cam, device=self.device),
        ).cpu().numpy()

        n_pair, n_feat = len(cams) * len(obj_ids), len(reproj_rows)
        boxes = packed[:4 * n_pair].reshape(len(cams), len(obj_ids), 4)
        drawn = packed[4 * n_pair:5 * n_pair].reshape(len(cams), len(obj_ids)) > 0
        rest = packed[5 * n_pair:]
        pixels, seen = rest[:2 * n_feat].reshape(n_feat, 2), rest[2 * n_feat:] > 0
        for c, cam_id in enumerate(cams):
            for o, obj_id in enumerate(obj_ids):
                if drawn[c, o]:
                    ov.predicted.append((cam_id, obj_id, boxes[c, o].copy()))
        for i, px, ok in zip(reproj_rows, pixels, seen):
            if ok:
                ov.reprojections[i] = px.copy()
        return ov

    # -- drawing ------------------------------------------------------------
    def _canvas(self, frame_id, cam_id):
        from PIL import Image

        img = None
        if self.image_provider is not None:
            img = self.image_provider(frame_id, cam_id)
        if img is not None:
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
            return Image.fromarray(arr.astype(np.uint8), "RGB")
        h, w = self.img_hw.get(cam_id, (480, 640))
        return Image.new("RGB", (int(w), int(h)), (40, 40, 40))

    @staticmethod
    def _draw_box(draw, corners, color, label=None, width=2):
        x_min, x_max, y_min, y_max = [float(c) for c in corners]
        if x_max < x_min or y_max < y_min:
            return
        draw.rectangle([x_min, y_min, x_max, y_max], outline=color, width=width)
        if label is not None:
            draw.text((x_min + 2, y_min + 2), str(label), fill=color)

    def _inflate(self, corners):
        # Full inflation_size per side, matching inflateBoundingBox
        # (ellipsoid_utils.h:354-361) and the frontend's association region.
        d = self.config.bounding_box_inflation_size
        return [corners[0] - d, corners[1] + d, corners[2] - d, corners[3] + d]

    def draw(self, ov: FrameOverlays) -> List[str]:
        """Draws ``ov`` with PIL, one image per camera
        (``bb_assoc_frame_{frame_id:06d}_cam_{cam_id}.png``); returns the
        paths. A predicted box wholly outside the image is skipped."""
        from PIL import ImageDraw

        paths = []
        inflate = self.config.bounding_box_inflation_size > 0
        for cam_id in ov.cam_ids:
            img = self._canvas(ov.frame_id, cam_id)
            draw = ImageDraw.Draw(img)
            for pred_cam, obj_id, px in ov.predicted:
                if pred_cam != cam_id:
                    continue
                if px[1] < 0 or px[0] > img.width or px[3] < 0 or px[2] > img.height:
                    continue
                self._draw_box(draw, px, self.colors["predicted"], label=f"p{obj_id}", width=1)
            for bb_cam_id, corners, obj_id in ov.assoc:
                if bb_cam_id != cam_id:
                    continue
                self._draw_box(draw, corners, self.colors["associated"], label=obj_id)
                if inflate:
                    self._draw_box(draw, self._inflate(corners),
                                   self.colors["associated_inflated"], width=1)
            for bb_cam_id, corners in ov.pending:
                if bb_cam_id != cam_id:
                    continue
                self._draw_box(draw, corners, self.colors["pending"])
                if inflate:
                    self._draw_box(draw, self._inflate(corners),
                                   self.colors["pending_inflated"], width=1)
            for (feat_cam_id, pixel, _), reproj in zip(ov.feats, ov.reprojections):
                if feat_cam_id != cam_id:
                    continue
                x, y = float(pixel[0]), float(pixel[1])
                draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=self.colors["feature"])
                if reproj is None:
                    continue
                rx, ry = float(reproj[0]), float(reproj[1])
                draw.ellipse([rx - 2, ry - 2, rx + 2, ry + 2],
                             outline=self.colors["feature_reproj"])
                draw.line([x, y, rx, ry], fill=self.colors["feature_reproj"])
            path = os.path.join(self.out_dir, f"bb_assoc_frame_{ov.frame_id:06d}_cam_{cam_id}.png")
            img.save(path)
            paths.append(path)
        return paths

    # -- main hook ------------------------------------------------------
    def bounding_box_front_end_visualization(
        self, pg, bb_frontend, frame_id, draw_feature_reprojections: bool = True
    ):
        """Render and save one debug image per camera seen at ``frame_id``."""
        if not self.out_dir:
            return []
        ov = self.frame_overlays(pg, bb_frontend, frame_id, draw_feature_reprojections)
        return [] if ov is None else self.draw(ov)


def _overlay_math(pose, ellipsoids, k, r_cr, t_cr, points, feat_cam):
    """The frame's overlay arithmetic on one device, packed into one vector:
    the pixel boxes of every (camera, object) pair (C x O x 4), their drawn
    flags (C x O: the reference's cheirality gate on the centre's depth and
    the corner math's ``valid``), the reprojected pixels of ``points``
    through camera ``feat_cam`` (F x 2) and their flags (F: the depth gate).
    A depth gate is ``not depth <= 0``, the reference's test: a NaN depth
    passes it."""
    n_cam, n_obj, n_feat = k.shape[0], ellipsoids.shape[0], points.shape[0]
    fx, fy, cx, cy = k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]
    parts = []
    if n_obj:
        cam = torch.arange(n_cam, device=k.device).repeat_interleave(n_obj)
        ell = ellipsoids.repeat(n_cam, 1)
        poses = pose.expand(n_cam * n_obj, 6)
        _, centre_depth = geo.project_point_rectified(poses, ell[:, :3], r_cr[cam], t_cr[cam])
        corners, valid = geo.ellipsoid_corners_rectified(ell, poses, r_cr[cam], t_cr[cam])
        px = torch.stack([fx[cam] * corners[:, 0] + cx[cam], fx[cam] * corners[:, 1] + cx[cam],
                          fy[cam] * corners[:, 2] + cy[cam], fy[cam] * corners[:, 3] + cy[cam]],
                         -1)
        parts += [px.reshape(-1), (~(centre_depth <= 0) & valid).to(px.dtype)]
    if n_feat:
        xy, depth = geo.project_point_rectified(
            pose.expand(n_feat, 6), points, r_cr[feat_cam], t_cr[feat_cam])
        rxy = torch.stack([fx[feat_cam] * xy[:, 0] + cx[feat_cam],
                           fy[feat_cam] * xy[:, 1] + cy[feat_cam]], -1)
        parts += [rxy.reshape(-1), (~(depth <= 0)).to(rxy.dtype)]
    if not parts:
        return pose.new_zeros(0)
    return torch.cat(parts)
