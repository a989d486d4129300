"""Frame/point data contracts shared across the media + perception layers
(host code, a copy of caliscope_tpu/packets.py).

Parity: reference src/caliscope/packets.py (PointPacket:14, FramePacket:51,
TrackedFrame:62, PixelFormat GRAY/BGR).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np


class PixelFormat(Enum):
    GRAY = "gray"
    BGR = "bgr"


@dataclass
class PointPacket:
    """2D points detected in a single frame by a tracker.

    obj_loc carries known object-frame coordinates where the tracker knows the
    target geometry (charuco/aruco); NaN otherwise (markerless pose points).
    """

    object_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    keypoint_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    img_loc: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    obj_loc: Optional[np.ndarray] = None  # (N,3) or None
    confidence: Optional[np.ndarray] = None  # (N,) or None

    def __post_init__(self):
        self.object_id = np.asarray(self.object_id, np.int64).ravel()
        self.keypoint_id = np.asarray(self.keypoint_id, np.int64).ravel()
        self.img_loc = np.asarray(self.img_loc, np.float64).reshape(-1, 2)
        if self.obj_loc is not None:
            self.obj_loc = np.asarray(self.obj_loc, np.float64).reshape(-1, 3)
        if self.confidence is not None:
            self.confidence = np.asarray(self.confidence, np.float64).ravel()

    def __len__(self) -> int:
        return len(self.keypoint_id)

    @classmethod
    def empty(cls) -> "PointPacket":
        return cls()


@dataclass
class FramePacket:
    """One decoded frame from one camera."""

    cam_id: int
    frame_index: int
    frame_time: float
    frame: Optional[np.ndarray]  # HxW (gray) or HxWx3 (BGR); None when skipped
    pixel_format: PixelFormat = PixelFormat.BGR

    @property
    def size(self) -> tuple[int, int]:
        assert self.frame is not None
        h, w = self.frame.shape[:2]
        return (w, h)


@dataclass
class TrackedFrame:
    """A frame plus its tracker output."""

    packet: FramePacket
    points: PointPacket

    @property
    def cam_id(self) -> int:
        return self.packet.cam_id

    @property
    def frame_index(self) -> int:
        return self.packet.frame_index
