"""Camera sidebar list with per-camera calibration status.

Port of caliscope_tpu/gui/widgets/camera_list.py.

Parity: reference src/caliscope/gui/camera_list_widget.py:1 — one row per
camera showing a filled/hollow status glyph plus RMSE for calibrated
cameras (glyph + color together, never color-alone), a camera_selected
signal on user selection, selection-preserving refresh, and programmatic
selection by cam_id.
"""

from __future__ import annotations

import logging

from caliscope_tpu_torch.gui.qt import (
    QBrush,
    QColor,
    QListWidget,
    QListWidgetItem,
    Qt,
    Signal,
)
from caliscope_tpu_torch.gui.theme import Colors, Styles

logger = logging.getLogger(__name__)


def _row_text_and_color(cam_id: int, camera) -> tuple[str, str]:
    """Row presentation for one camera: (label, color). Calibrated cameras
    get a filled glyph + RMSE suffix; uncalibrated a hollow glyph."""
    calibrated = camera.matrix is not None and camera.distortions is not None
    if not calibrated:
        return f"○ Cam {cam_id}", Colors.ERROR
    err = getattr(camera, "error", None)
    suffix = "" if err is None else f" — {err:.2f}px"
    return f"● Cam {cam_id}{suffix}", Colors.SUCCESS


class CameraListWidget(QListWidget):
    """Sidebar list of cameras with calibration state indicators.

    Emits camera_selected(cam_id) when the user picks a different camera.
    """

    camera_selected = Signal(int)

    def __init__(self, camera_array):
        super().__init__()
        self._row_cam_ids: list[int] = []
        self.setStyleSheet(Styles.LIST_SIDEBAR)
        self._rebuild(camera_array)
        self.currentRowChanged.connect(self._emit_selection)

    def _rebuild(self, camera_array) -> None:
        self.clear()
        self._row_cam_ids = sorted(camera_array.cameras)
        for cam_id in self._row_cam_ids:
            text, color = _row_text_and_color(cam_id, camera_array.cameras[cam_id])
            item = QListWidgetItem(text)
            item.setData(Qt.ItemDataRole.UserRole, cam_id)
            item.setForeground(QBrush(QColor(color)))
            self.addItem(item)

    def _emit_selection(self, row: int) -> None:
        if 0 <= row < len(self._row_cam_ids):
            picked = self._row_cam_ids[row]
            logger.info(f"Camera list selection -> cam {picked}")
            self.camera_selected.emit(picked)

    def refresh(self, camera_array) -> None:
        """Rebuild rows from updated camera data, preserving the current
        selection WITHOUT re-emitting camera_selected (a visual update must
        not tear down the active presenter)."""
        row = self.currentRow()
        keep = self._row_cam_ids[row] if 0 <= row < len(self._row_cam_ids) else None
        self._rebuild(camera_array)
        if keep in self._row_cam_ids:
            was = self.blockSignals(True)
            try:
                self.setCurrentRow(self._row_cam_ids.index(keep))
            finally:
                self.blockSignals(was)

    def select_cam_id(self, cam_id: int) -> None:
        if cam_id in self._row_cam_ids:
            self.setCurrentRow(self._row_cam_ids.index(cam_id))
