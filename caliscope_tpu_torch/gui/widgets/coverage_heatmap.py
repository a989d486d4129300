"""Per-camera observation coverage heatmap.

Port of caliscope_tpu/gui/widgets/coverage_heatmap.py.

Parity: reference gui/widgets/coverage_heatmap.py — density of calibration
observations over the sensor, per camera, with the fraction-covered readout
the intrinsic report uses.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.qt import QComboBox, QHBoxLayout, QLabel, QVBoxLayout, QWidget
from caliscope_tpu_torch.gui.rendering import render_coverage_heatmap, to_pixmap
from caliscope_tpu_torch.observations import ImagePoints


class CoverageHeatmapWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        row = QHBoxLayout()
        row.addWidget(QLabel("Camera:"))
        self.cam_box = QComboBox()
        self.cam_box.currentTextChanged.connect(lambda _t: self._render())
        row.addWidget(self.cam_box)
        self.stats = QLabel("")
        row.addWidget(self.stats)
        layout.addLayout(row)
        self.canvas = QLabel()
        layout.addWidget(self.canvas)
        self._points: ImagePoints | None = None
        self._sizes: dict[int, tuple[int, int]] = {}

    def set_data(self, points: ImagePoints, cam_sizes: dict[int, tuple[int, int]]) -> None:
        self._points = points
        self._sizes = cam_sizes
        current = self.cam_box.currentText()
        self.cam_box.clear()
        for cid in sorted(cam_sizes):
            self.cam_box.addItem(str(cid))
        if current and self.cam_box.findText(current) >= 0:
            self.cam_box.setCurrentText(current)
        self._render()

    def coverage_fraction(self, cam_id: int, grid=(16, 12)) -> float:
        """Fraction of grid cells containing at least one observation."""
        if self._points is None or cam_id not in self._sizes:
            return 0.0
        sel = self._points.cam_id == cam_id
        xy = self._points.img_xy[sel]
        W, H = self._sizes[cam_id]
        hist, _, _ = np.histogram2d(xy[:, 1], xy[:, 0], bins=(grid[1], grid[0]), range=((0, H), (0, W)))
        return float((hist > 0).mean())

    def _render(self) -> None:
        if self._points is None or not self.cam_box.currentText():
            return
        cam_id = int(self.cam_box.currentText())
        sel = self._points.cam_id == cam_id
        xy = self._points.img_xy[sel]
        img = render_coverage_heatmap(xy, self._sizes[cam_id])
        self.canvas.setPixmap(to_pixmap(img))
        self.stats.setText(
            f"{int(sel.sum())} observations, {self.coverage_fraction(cam_id):.0%} of cells covered"
        )
