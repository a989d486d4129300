"""Tracker ABC: the perception-layer contract (host code, a copy of
caliscope_tpu/tracker.py).

Parity: reference src/caliscope/tracker.py (Tracker:15 with pixel-format
enforcement in get_points:28-52, WireFrameView:98, Segment). Trackers consume
frames and emit PointPackets; identity schemes per tracker type:
charuco/chessboard -> object_id 0 (1 = back face), keypoint_id = corner index;
aruco -> object_id = marker_id, keypoint_id = corner 0..3.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

import numpy as np

from caliscope_tpu_torch.packets import PixelFormat, PointPacket

logger = logging.getLogger(__name__)


class Tracker(ABC):
    # where the tracker runs, and the videos it reads decode: CUDA when None
    device = None

    @property
    def name(self) -> str:
        """Tracker name, used for artifact file naming (xy_{NAME}.csv)."""
        return "Name Me"

    @property
    def pixel_format(self) -> PixelFormat:
        return PixelFormat.BGR

    def get_points(self, frame: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> PointPacket:
        """Enforce the pixel-format contract, then delegate to _detect."""
        frame = self._ensure_format(frame)
        return self._detect(frame, cam_id, rotation_count)

    def get_points_batch(self, frames: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> list[PointPacket]:
        """Batched detection over a (B, H, W[, 3]) stack of frames.

        Default loops _detect; device-batched trackers override this to run
        the whole stack through the device pipeline in chunks.
        """
        return [self.get_points(frames[i], cam_id, rotation_count) for i in range(len(frames))]

    def _ensure_format(self, frame: np.ndarray) -> np.ndarray:
        if self.pixel_format == PixelFormat.GRAY and frame.ndim == 3:
            logger.warning(
                "%s received BGR frame, expected grayscale — converting. Pass "
                "pixel_format=tracker.pixel_format to FrameSource for zero-cost gray extraction.",
                type(self).__name__,
            )
            return (frame @ np.array([0.114, 0.587, 0.299])).astype(frame.dtype)
        if self.pixel_format == PixelFormat.BGR and frame.ndim == 2:
            logger.warning("%s received grayscale frame, expected BGR — converting.", type(self).__name__)
            return np.repeat(frame[..., None], 3, axis=2)
        return frame

    @abstractmethod
    def _detect(self, frame: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> PointPacket:
        ...

    @abstractmethod
    def get_point_name(self, keypoint_id: int) -> str:
        ...

    def scatter_draw_instructions(self, keypoint_id: int) -> dict:
        """keypoint_id -> draw parameters for overlay rendering."""
        return {"radius": 4, "color": (0, 220, 40), "thickness": -1}

    @property
    def wireframe(self) -> Optional["WireFrameView"]:
        return None

    def get_connected_points(self) -> set[tuple[int, int]]:
        """Pairs of keypoint_ids to join with overlay lines."""
        return set()

    def cleanup(self) -> None:
        """Release resources; no-op for stateless trackers."""


@dataclass(slots=True, frozen=True)
class Segment:
    name: str
    color: str  # one of: r, g, b, c, m, y, k, w
    point_A: str
    point_B: str
    width: float = 1


@dataclass(slots=True, frozen=True)
class WireFrameView:
    """Wireframe topology for 3D visualization."""

    segments: tuple[Segment, ...]
    point_names: dict[str, int]

    def edges_by_id(self) -> list[tuple[int, int]]:
        out = []
        for s in self.segments:
            a = self.point_names.get(s.point_A)
            b = self.point_names.get(s.point_B)
            if a is not None and b is not None:
                out.append((a, b))
        return out
