"""Informational placeholder for the Cameras tab when no intrinsic videos exist.

Port of caliscope_tpu/gui/widgets/cameras_placeholder.py.

Parity: reference src/caliscope/gui/widgets/cameras_info_placeholder.py:1 —
instead of a greyed-out tab that reads as "stuck", the tab stays active and
explains that skipping intrinsic calibration is a supported path (extrinsic
calibration can recover lens parameters when the capture supports it) and
what the capture needs for that to work.
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.qt import QLabel, QVBoxLayout, QWidget

PLACEHOLDER_TEXT = """No intrinsic calibration videos

This tab calibrates each camera's lens (focal length, distortion) from
videos in calibration/intrinsic/. This project has none — and that can be
fine. Extrinsic calibration can recover lens parameters on its own if the
capture supports it:

- Move the target toward and away from the cameras, not just across the view.
- Measure marker sizes accurately — they set the world scale.
- No fisheye lenses. Those need intrinsic calibration first.

If that matches your capture, continue on the Extract tab. To calibrate
intrinsics here instead, add calibration/intrinsic/cam_N.mp4 videos and
this tab will activate."""


class CamerasInfoPlaceholder(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        self.label = QLabel(PLACEHOLDER_TEXT)
        self.label.setWordWrap(True)
        layout.addWidget(self.label)
        layout.addStretch(1)
