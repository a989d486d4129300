"""Lens model visualizer: intrinsics readout + distortion grid preview.

Port of caliscope_tpu/gui/widgets/lens_model.py.

Parity: reference gui/lens_model_visualizer.py + lens_model_dialog.py —
shows K, distortion coefficients, and how the lens bends a straight grid.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.cameras import CameraData
from caliscope_tpu_torch.gui.qt import QHBoxLayout, QLabel, QVBoxLayout, QWidget
from caliscope_tpu_torch.gui.rendering import render_undistortion_grid, to_pixmap


class LensModelWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QHBoxLayout(self)
        self.canvas = QLabel()
        layout.addWidget(self.canvas)
        right = QVBoxLayout()
        self.params = QLabel("No intrinsics yet.")
        self.params.setWordWrap(True)
        right.addWidget(self.params)
        right.addStretch(1)
        layout.addLayout(right)

    def update_from_camera(self, cam: CameraData) -> None:
        self.canvas.setPixmap(to_pixmap(render_undistortion_grid(cam)))
        if cam.matrix is None:
            self.params.setText("No intrinsics yet.")
            return
        k = cam.matrix
        dist = np.zeros(5) if cam.distortions is None else np.asarray(cam.distortions).ravel()
        err = f"{cam.error:.3f} px RMSE" if cam.error is not None else "unreported error"
        lines = [
            f"camera {cam.cam_id} ({cam.size[0]}x{cam.size[1]}{', fisheye' if cam.fisheye else ''})",
            f"fx={k[0, 0]:.1f}  fy={k[1, 1]:.1f}",
            f"cx={k[0, 2]:.1f}  cy={k[1, 2]:.1f}",
            "dist=[" + ", ".join(f"{d:+.4f}" for d in dist[:5]) + "]",
            err,
        ]
        self.params.setText("\n".join(lines))
