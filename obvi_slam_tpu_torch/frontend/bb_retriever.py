"""Bounding-box retrieval: precomputed files or a live detector process.

Re-design of ``bounding_box_retriever.h``: the reference queries a YOLOv5
fork through the ROS service ``/yolov5_detect_objs`` per image
(``YoloBoundingBoxQuerier``, :33-171) and prefers file-loaded detections when
available (``retrievePrecomputedBoundingBoxes``, :16-31, wired at
offline_object_visual_slam_main.cpp:883-897). This port keeps the same
two-tier contract without a ROS runtime:

  - ``PrecomputedBoundingBoxRetriever``   — detections from the problem data
    (the CSV-ingested path), exactly retrievePrecomputedBoundingBoxes.
  - ``SubprocessDetectorQuerier``         — the service-RPC equivalent: a
    long-lived detector WORKER PROCESS speaking newline-delimited JSON on
    stdin/stdout. Per image: request {"image_path", "frame_id", "camera_id"},
    response {"detections": [{"label", "conf", "xyxy": [x1,y1,x2,y2]}]}.
    Corner validation (>= 0, <= image dims, reference :88-104) and
    crash-regeneration of the worker (reference regenerateClient, :127-143)
    are replicated.

Any detector (a YOLO checkpoint under torch, an ONNX runtime, a remote
endpoint shim) plugs in by providing the worker executable.

This module is a copy of ``obvi_slam_tpu/frontend/bb_retriever.py`` (numpy
and the standard library); the port keeps its own copy and imports nothing
of the JAX package.
"""

from __future__ import annotations

import json
import logging
import subprocess
from typing import Dict, List, Optional

import numpy as np

from obvi_slam_tpu_torch.offline_data import RawBoundingBox

logger = logging.getLogger(__name__)


class PrecomputedBoundingBoxRetriever:
    """retrievePrecomputedBoundingBoxes (bounding_box_retriever.h:16-31)."""

    def __init__(self, data):
        self.data = data

    def retrieve_bounding_boxes(
        self, frame_id: int
    ) -> Optional[Dict[int, List[RawBoundingBox]]]:
        """frame -> {cam: [RawBoundingBox]} or None if absent."""
        return self.data.bounding_boxes.get(frame_id)


class SubprocessDetectorQuerier:
    """YoloBoundingBoxQuerier equivalent over a worker subprocess.

    ``detector_command``: argv list for the worker. The worker reads one JSON
    request per line on stdin and writes one JSON response per line on
    stdout; it must flush after each response.
    ``image_provider(frame_id, camera_id) -> (path, (height, width))`` maps a
    query to an image file and its dimensions (for corner validation).
    """

    def __init__(self, detector_command, image_provider, max_restarts: int = 2):
        self.detector_command = list(detector_command)
        self.image_provider = image_provider
        self.max_restarts = max_restarts
        self._proc: Optional[subprocess.Popen] = None
        if not self._regenerate_worker():
            raise RuntimeError(
                f"detector worker {self.detector_command} failed to start"
            )

    # -- worker lifecycle (regenerateClient, :127-143) ------------------
    def _regenerate_worker(self) -> bool:
        self.close()
        try:
            self._proc = subprocess.Popen(
                self.detector_command,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                text=True,
                bufsize=1,
            )
        except OSError as e:
            logger.warning("detector worker failed to start: %s", e)
            self._proc = None
            return False
        return True

    def close(self):
        if self._proc is not None:
            try:
                self._proc.stdin.close()
                self._proc.terminate()
                self._proc.wait(timeout=5)
            except Exception:
                self._proc.kill()
            self._proc = None

    def _call(self, request: dict) -> Optional[dict]:
        for attempt in range(self.max_restarts + 1):
            if self._proc is None or self._proc.poll() is not None:
                if not self._regenerate_worker():
                    return None
                logger.warning("detector worker regenerated (attempt %d)", attempt)
            try:
                self._proc.stdin.write(json.dumps(request) + "\n")
                self._proc.stdin.flush()
                line = self._proc.stdout.readline()
                if line:
                    return json.loads(line)
            except (BrokenPipeError, OSError, json.JSONDecodeError) as e:
                logger.warning("detector worker call failed: %s", e)
            # worker died mid-call -> regenerate and retry
            self._proc = None
        return None

    # -- queries (retrieveBoundingBoxesForImage, :67-118) ---------------
    def retrieve_bounding_boxes_for_image(
        self, frame_id: int, camera_id: int
    ) -> Optional[List[RawBoundingBox]]:
        provided = self.image_provider(frame_id, camera_id)
        if provided is None:
            return None
        image_path, (height, width) = provided
        resp = self._call(
            {
                "image_path": str(image_path),
                "frame_id": int(frame_id),
                "camera_id": int(camera_id),
            }
        )
        if resp is None:
            return None
        out = []
        for det in resp.get("detections", []):
            xyxy = det["xyxy"]
            valid = True
            for idx, v in enumerate(xyxy):
                if v < 0:
                    logger.warning(
                        "Bounding box corner pixel has coordinate less than "
                        "0. Discarding"
                    )
                    valid = False
                    break
                corner_max = height if (idx % 2) else width
                if v > corner_max:
                    logger.warning(
                        "Bounding box corner pixel has coordinate %s higher "
                        "than max dimension %s. Discarding", v, corner_max
                    )
                    valid = False
                    break
            if not valid:
                continue
            out.append(
                RawBoundingBox(
                    # internal order [x_min, x_max, y_min, y_max]
                    np.array(
                        [xyxy[0], xyxy[2], xyxy[1], xyxy[3]], dtype=np.float64
                    ),
                    det["label"],
                    float(det.get("conf", 1.0)),
                )
            )
        return out

    def retrieve_bounding_boxes(
        self, frame_id: int, camera_ids
    ) -> Dict[int, List[RawBoundingBox]]:
        """Per-frame query over all cameras (retrieveBoundingBoxes, :54-65)."""
        out = {}
        for cam_id in camera_ids:
            bbs = self.retrieve_bounding_boxes_for_image(frame_id, cam_id)
            if bbs is not None:
                out[cam_id] = bbs
        return out


def make_bb_frontend_hook_with_querier(frontend, querier, camera_ids):
    """Runner bb_frontend hook preferring precomputed detections and falling
    back to the live querier (offline_object_visual_slam_main.cpp:872-898)."""

    def hook(data, pg, frame_id):
        bbs_by_cam = data.bounding_boxes.get(frame_id)
        if bbs_by_cam is None:
            bbs_by_cam = querier.retrieve_bounding_boxes(frame_id, camera_ids)
            data.bounding_boxes[frame_id] = bbs_by_cam
        feats = data.features_for_frame(frame_id)
        for cam_id, bbs in bbs_by_cam.items():
            observed = {
                feat_id: cams[cam_id]
                for feat_id, cams in feats.items()
                if cam_id in cams
            }
            frontend.add_bounding_box_observations(frame_id, cam_id, bbs, observed)

    return hook
