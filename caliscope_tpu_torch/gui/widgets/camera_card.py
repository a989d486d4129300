"""Per-camera thumbnail card with frame-rotation control.

Port of caliscope_tpu/gui/widgets/camera_card.py.

Parity: reference gui/views/camera_thumbnail_card.py + camera_list_widget —
sideways-mounted cameras are corrected by quarter-turn `rotation_count`
steps; the card shows the camera's first intrinsic-video frame at the
current rotation and persists changes through the workspace camera
repository so every downstream consumer (trackers, extraction, GUI
playback) sees the same orientation.
"""

from __future__ import annotations

import logging

import numpy as np

from caliscope_tpu_torch.gui.qt import QHBoxLayout, QLabel, QPushButton, QVBoxLayout, QWidget
from caliscope_tpu_torch.gui.rendering import to_pixmap

logger = logging.getLogger(__name__)

_THUMB_W = 192


class CameraThumbnailCard(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        self.thumb = QLabel()
        layout.addWidget(self.thumb)
        row = QHBoxLayout()
        self.ccw_btn = QPushButton("⟲ 90°")
        self.cw_btn = QPushButton("⟳ 90°")
        self.ccw_btn.clicked.connect(lambda: self.rotate(-1))
        self.cw_btn.clicked.connect(lambda: self.rotate(1))
        row.addWidget(self.ccw_btn)
        row.addWidget(self.cw_btn)
        self.caption = QLabel("")
        row.addWidget(self.caption)
        layout.addLayout(row)
        self._ws = None
        self._cam_id: int | None = None
        self._frame: np.ndarray | None = None  # un-rotated RGB

    def set_camera(self, workspace, cam_id: int, stage: str = "intrinsic") -> None:
        self._ws = workspace
        self._cam_id = int(cam_id)
        self._frame = self._first_frame(stage)
        self._render()

    @property
    def rotation_count(self) -> int:
        if self._ws is None or self._cam_id is None or not self._ws.cameras.exists():
            return 0
        cam = self._ws.cameras.load().cameras.get(self._cam_id)
        return int(cam.rotation_count) if cam is not None else 0

    def rotate(self, step: int) -> None:
        """Quarter-turn the camera's frames (+1 = clockwise); persists."""
        if self._ws is None or self._cam_id is None or not self._ws.cameras.exists():
            return
        arr = self._ws.cameras.load()
        cam = arr.cameras.get(self._cam_id)
        if cam is None:
            return
        cam.rotation_count = (int(cam.rotation_count) + step) % 4
        self._ws.cameras.save(arr)
        self._render()

    def _first_frame(self, stage: str) -> np.ndarray | None:
        if self._ws is None or self._cam_id is None:
            return None
        path = self._ws.video_path(stage, self._cam_id)
        if not path.exists():
            return None
        try:
            from caliscope_tpu_torch.media.video import FrameSource

            src = FrameSource(path, self._cam_id, device=self._ws.device)
            pkt = src.next_frame()
            src.close()
            if pkt is None:
                return None
            frame = pkt.frame
            if frame.ndim == 3:
                frame = frame[..., ::-1]  # BGR -> RGB
            else:
                frame = np.repeat(frame[..., None], 3, axis=-1)
            # downscale by stride to thumbnail width
            stride = max(1, frame.shape[1] // _THUMB_W)
            return np.ascontiguousarray(frame[::stride, ::stride])
        except Exception:
            logger.exception(f"Could not load a thumbnail frame for camera {self._cam_id}")
            return None

    def _render(self) -> None:
        rc = self.rotation_count
        self.caption.setText(
            f"cam {self._cam_id}" + (f" · rotated {rc * 90}°" if rc else "")
        )
        if self._frame is None:
            img = np.zeros((96, _THUMB_W, 3), np.uint8)
            img[:] = (18, 20, 26)
        else:
            # rotation_count is clockwise quarter turns; rot90 is CCW
            img = np.ascontiguousarray(np.rot90(self._frame, k=(-rc) % 4))
        self._thumb_array = img
        self.thumb.setPixmap(to_pixmap(img))

    @property
    def thumb_array(self) -> np.ndarray:
        """Rendered thumbnail (headless-assertable)."""
        return getattr(self, "_thumb_array", np.zeros((1, 1, 3), np.uint8))
