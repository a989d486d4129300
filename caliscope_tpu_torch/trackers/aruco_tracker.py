"""ArUco marker-set tracker.

Port of caliscope_tpu/trackers/aruco_tracker.py. Detection runs through
detect/aruco.py::detect_markers on the tracker's device — the CUDA device
unless `device` names another (it raises without one) — where it launches the
labeling and window-gather kernels (csrc/ccl.cu, csrc/extract_windows.cu);
`get_points` sends one frame, `get_points_batch` the whole stack.

Reference src/caliscope/trackers/aruco_tracker.py:33 — identity: object_id =
marker_id, keypoint_id = corner 0..3 (TL, TR, BR, BL); obj_loc from the marker
set's local corner geometry. No mirror redetect: a flipped ArUco bit pattern
can decode as a DIFFERENT valid id, so mirror handling is modeled explicitly
via MirrorPair in the marker set (reference aruco_tracker.py:10-13).
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.detect.aruco import detect_markers
from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.packets import PixelFormat, PointPacket
from caliscope_tpu_torch.targets.aruco import ArucoMarkerSet
from caliscope_tpu_torch.tracker import Tracker

_CORNER_NAMES = ["TL", "TR", "BR", "BL"]


class ArucoTracker(Tracker):
    def __init__(self, marker_set: ArucoMarkerSet, device=None):
        """device: the torch device detection runs on; the CUDA device by
        default, and then it raises when there is none."""
        self.marker_set = marker_set
        self.device = resolve_device(device)

    @property
    def name(self) -> str:
        return "ARUCO"

    @property
    def pixel_format(self) -> PixelFormat:
        return PixelFormat.GRAY

    def _packets_from_detections(self, detections) -> PointPacket:
        known = self.marker_set.markers
        obj_ids, kp_ids, img, obj = [], [], [], []
        for mid, corners in zip(detections.ids, detections.corners):
            marker = known.get(int(mid))
            if marker is None:
                continue  # same dictionary, not part of this set
            local = marker.corners
            for k in range(4):
                obj_ids.append(int(mid))
                kp_ids.append(k)
                img.append(corners[k])
                obj.append(local[k])
        if not obj_ids:
            return PointPacket.empty()
        return PointPacket(np.array(obj_ids), np.array(kp_ids), np.array(img), np.array(obj))

    def _detect(self, frame: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> PointPacket:
        dets = detect_markers(frame[None], self.marker_set.dictionary, device=self.device)[0]
        return self._packets_from_detections(dets)

    def get_points_batch(self, frames: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> list[PointPacket]:
        """One device program for the whole frame stack."""
        all_dets = detect_markers(np.asarray(frames), self.marker_set.dictionary, device=self.device)
        return [self._packets_from_detections(d) for d in all_dets]

    def get_point_name(self, keypoint_id: int) -> str:
        return _CORNER_NAMES[int(keypoint_id) % 4]

    def get_connected_points(self) -> set[tuple[int, int]]:
        return {(0, 1), (1, 2), (2, 3), (3, 0)}
