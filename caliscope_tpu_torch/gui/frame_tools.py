"""Frame display helpers: rotation, square padding, numpy -> QImage.

Port of caliscope_tpu/gui/frame_tools.py.

Parity: reference src/caliscope/gui/frame_emitters/tools.py:1
(resize_to_square, apply_rotation, cv2_to_qlabel) — pure numpy here (no
cv2 dependency in the GUI layer; np.rot90 and np.pad are exact
equivalents of cv2.rotate / copyMakeBorder for these uses), and the
QImage conversion goes through gui/rendering.to_qimage so both Qt
backends get identical, assertable pixels.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.rendering import to_qimage


def resize_to_square(frame: np.ndarray) -> np.ndarray:
    """Zero-pad a frame to a centered square (max edge)."""
    h, w = frame.shape[:2]
    size = max(h, w)
    ph, pw = (size - h) // 2, (size - w) // 2
    widths = [(ph, size - h - ph), (pw, size - w - pw)] + [(0, 0)] * (frame.ndim - 2)
    return np.pad(frame, widths, constant_values=0)


def apply_rotation(frame: np.ndarray, rotation_count: int) -> np.ndarray:
    """Rotate by 90-degree steps; rotation_count > 0 is clockwise (the
    reference's camera-rotation convention, frame_emitters/tools.py:33)."""
    k = -(rotation_count % 4)  # np.rot90 is counter-clockwise
    return np.ascontiguousarray(np.rot90(frame, k)) if k else frame


def frame_to_qimage(frame: np.ndarray):
    """(H, W[, 3]) uint8 -> QImage (gray frames broadcast to RGB)."""
    if frame.ndim == 2:
        frame = np.repeat(frame[:, :, None], 3, axis=2)
    return to_qimage(frame[:, :, :3])
