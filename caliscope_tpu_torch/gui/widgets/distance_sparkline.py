"""Compact per-frame distance-error sparkline.

Port of caliscope_tpu/gui/widgets/distance_sparkline.py.

Parity: reference gui/widgets/distance_sparkline.py:14-260 — a small
always-visible strip beside the playback slider showing the per-frame
scale error (distance RMSE, mm) across the sampled sync indices, with a
frame cursor tied to the slider and a y-max label. The reference paints
with QPainter; this rasterizes to numpy (gui/rendering.py) so the SAME
widget runs under real Qt and the headless shim, and the geometry helpers
(`position_at_x`, `value_at_position`) are plain methods shared by mouse
events and presenter tests.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.qt import QHBoxLayout, QLabel, QWidget
from caliscope_tpu_torch.gui.rendering import to_pixmap


def _make_signal():
    class _Sig:
        def __init__(self):
            self._subs = []

        def connect(self, fn):
            self._subs.append(fn)

        def emit(self, *a):
            for fn in list(self._subs):
                fn(*a)

    return _Sig()


class DistanceSparkline(QWidget):
    """set_data(report, valid_sync_indices) -> polyline over the slider's
    position domain; set_cursor(position) draws the playback cursor;
    hovering (or `position_at_x` in tests) maps pixels back to slider
    positions. `cursor_moved(position)` fires on hover-driven seeks."""

    W, H = 360, 44

    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QHBoxLayout(self)
        layout.setContentsMargins(0, 0, 0, 0) if hasattr(layout, "setContentsMargins") else None
        self.canvas = QLabel()
        layout.addWidget(self.canvas)
        self.ymax_label = QLabel("")
        layout.addWidget(self.ymax_label)
        self.cursor_moved = _make_signal()
        self._positions: np.ndarray = np.zeros(0, int)  # slider positions with data
        self._values: np.ndarray = np.zeros(0)  # mm per position
        self._max_position = 0
        self._cursor: int | None = None
        self._render()

    # ---- data ------------------------------------------------------------
    def set_data(self, report, valid_sync_indices) -> None:
        """report: VolumetricScaleReport; valid_sync_indices: the slider's
        position->sync mapping (position i shows sync valid_sync_indices[i]).
        Frames without a scale sample simply have no vertex (the reference
        skips them identically)."""
        sync_to_mm = {}
        for fe in report.frame_errors:
            sync_to_mm.setdefault(int(fe.sync_index), []).append(fe.distance_rmse_mm)
        valid = np.asarray(valid_sync_indices, int)
        self._max_position = max(len(valid) - 1, 0)
        pos, vals = [], []
        for i, s in enumerate(valid):
            if int(s) in sync_to_mm:
                pos.append(i)
                vals.append(float(np.max(sync_to_mm[int(s)])))
        self._positions = np.asarray(pos, int)
        self._values = np.asarray(vals)
        self.ymax_label.setText(f"≤{self._values.max():.1f} mm" if len(vals) else "")
        self._render()

    def clear(self) -> None:
        self._positions = np.zeros(0, int)
        self._values = np.zeros(0)
        self._max_position = 0
        self._cursor = None
        self.ymax_label.setText("")
        self._render()

    def set_cursor(self, position: int | None) -> None:
        self._cursor = position
        self._render()

    # ---- geometry (shared by mouse events and tests) ---------------------
    def _x_of(self, position: int) -> int:
        if self._max_position == 0:
            return 0
        return int(round(position * (self.W - 1) / self._max_position))

    def position_at_x(self, x: float) -> int | None:
        if self._max_position == 0 or not (0 <= x < self.W):
            return None
        return int(round(x * self._max_position / (self.W - 1)))

    def value_at_position(self, position: int) -> float | None:
        hits = np.where(self._positions == position)[0]
        return float(self._values[hits[0]]) if len(hits) else None

    def hover(self, x: float) -> None:
        """Programmatic hover-seek (mouseMoveEvent routes here)."""
        p = self.position_at_x(x)
        if p is not None:
            self.cursor_moved.emit(p)

    def mouseMoveEvent(self, event):  # pragma: no cover - real Qt only
        try:
            self.hover(event.position().x())
        except Exception:
            pass

    # ---- rendering -------------------------------------------------------
    def _render(self) -> None:
        img = np.zeros((self.H, self.W, 3), np.uint8)
        img[:] = (18, 20, 26)
        if len(self._values):
            peak = max(float(self._values.max()), 1e-9)
            ys = (self.H - 3 - (self.H - 6) * self._values / peak).astype(int)
            xs = np.array([self._x_of(int(p)) for p in self._positions])
            if len(xs) == 1:
                img[max(ys[0] - 1, 0) : ys[0] + 2, max(xs[0] - 1, 0) : xs[0] + 2] = (86, 156, 214)
            else:
                for i in range(len(xs) - 1):
                    for t in np.linspace(0.0, 1.0, max(abs(xs[i + 1] - xs[i]), 1) + 1):
                        x = int(round(xs[i] + t * (xs[i + 1] - xs[i])))
                        y = int(round(ys[i] + t * (ys[i + 1] - ys[i])))
                        img[max(y - 1, 0) : y + 1, x] = (86, 156, 214)
        if self._cursor is not None and self._max_position:
            img[:, min(self._x_of(self._cursor), self.W - 1)] = (220, 163, 86)
        self._chart = img
        self.canvas.setPixmap(to_pixmap(img))

    @property
    def chart_array(self) -> np.ndarray:
        return self._chart
