"""Scale-accuracy detail dialog.

Port of caliscope_tpu/gui/widgets/scale_detail_dialog.py.

Parity: reference gui/widgets/scale_detail_dialog.py:14-409 — the expanded
per-frame scale chart (axes, gridlines, hover cursor, click-to-seek) plus
the summary statistics the compact quality-tab chart omits, and a
per-frame table (sync index, object, RMSE mm, signed bias mm, pairs,
cameras). Rendering rasterizes to numpy so the dialog runs under real Qt
and the headless shim; `position_at_x`/`sync_at_x` are plain methods
shared by mouse events and presenter tests.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.qt import (
    QDialog,
    QHBoxLayout,
    QLabel,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
)
from caliscope_tpu_torch.gui.rendering import to_pixmap

_MARGIN_L, _MARGIN_B, _MARGIN_T = 44, 18, 8


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


class ScaleDetailDialog(QDialog):
    """set_data(report, valid_sync_indices) fills the chart, the summary
    row (pooled / median / max RMSE + signed bias — VolumetricScaleReport's
    own statistics), and the per-frame table; `frame_clicked(sync_index)`
    fires on chart clicks so the owner can seek the playback."""

    W, H = 640, 240

    def __init__(self, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Scale accuracy detail") if hasattr(self, "setWindowTitle") else None
        layout = QVBoxLayout(self)
        self.summary = QLabel("No scale data.")
        self.summary.setWordWrap(True)
        layout.addWidget(self.summary)
        self.canvas = QLabel()
        layout.addWidget(self.canvas)
        row = QHBoxLayout()
        self.hover_label = QLabel("")
        row.addWidget(self.hover_label)
        layout.addLayout(row)
        self.table = QTableWidget(0, 6)
        self.table.setHorizontalHeaderLabels(
            ["sync", "object", "rmse (mm)", "bias (mm)", "pairs", "cameras"]
        )
        layout.addWidget(self.table)
        self.frame_clicked = _make_signal()
        self._sync = np.zeros(0, int)
        self._mm = np.zeros(0)
        self._positions = np.zeros(0, int)
        self._max_position = 0
        self._cursor: int | None = None
        self._render()

    # ---- data ------------------------------------------------------------
    def set_data(self, report, valid_sync_indices) -> None:
        frames = sorted(report.frame_errors, key=lambda fe: (fe.sync_index, fe.object_id))
        valid = np.asarray(valid_sync_indices, int)
        pos_of = {int(s): i for i, s in enumerate(valid)}
        self._max_position = max(len(valid) - 1, 0)
        keep = [fe for fe in frames if int(fe.sync_index) in pos_of]
        self._sync = np.array([fe.sync_index for fe in keep], int)
        self._mm = np.array([fe.distance_rmse_mm for fe in keep])
        self._positions = np.array([pos_of[int(fe.sync_index)] for fe in keep], int)
        if keep:
            self.summary.setText(
                f"{report.n_frames_sampled} sampled frames: pooled RMSE "
                f"{report.pooled_rmse_mm:.2f} mm, median {report.median_rmse_mm:.2f} mm, "
                f"max {report.max_rmse_mm:.2f} mm, bias {report.mean_signed_error_mm:+.2f} mm"
            )
        else:
            self.summary.setText("No scale data.")
        self.table.setRowCount(len(keep))
        for i, fe in enumerate(keep):
            for j, text in enumerate(
                [
                    str(fe.sync_index),
                    str(fe.object_id),
                    f"{fe.distance_rmse_mm:.2f}",
                    f"{fe.distance_mean_signed_error_mm:+.2f}",
                    str(fe.n_distance_pairs),
                    str(fe.n_cameras_contributing),
                ]
            ):
                self.table.setItem(i, j, QTableWidgetItem(text))
        self._render()

    def set_cursor(self, position: int | None) -> None:
        self._cursor = position
        self._render()

    # ---- geometry (shared by mouse events and tests) ---------------------
    def _plot_w(self) -> int:
        return self.W - _MARGIN_L - 4

    def _x_of(self, position: int) -> int:
        if self._max_position == 0:
            return _MARGIN_L
        return _MARGIN_L + int(round(position * (self._plot_w() - 1) / self._max_position))

    def position_at_x(self, x: float) -> int | None:
        if self._max_position == 0 or not (_MARGIN_L <= x < _MARGIN_L + self._plot_w()):
            return None
        return int(round((x - _MARGIN_L) * self._max_position / (self._plot_w() - 1)))

    def sync_at_x(self, x: float) -> int | None:
        p = self.position_at_x(x)
        if p is None or len(self._positions) == 0:
            return None
        i = int(np.argmin(np.abs(self._positions - p)))
        return int(self._sync[i])

    def click(self, x: float) -> None:
        s = self.sync_at_x(x)
        if s is not None:
            self.frame_clicked.emit(s)

    def hover(self, x: float) -> None:
        p = self.position_at_x(x)
        if p is None:
            self.hover_label.setText("")
            return
        hits = np.where(self._positions == p)[0]
        if len(hits):
            i = int(hits[0])
            self.hover_label.setText(f"sync {int(self._sync[i])}: {self._mm[i]:.2f} mm")
        else:
            self.hover_label.setText(f"position {p}: no sample")

    def mousePressEvent(self, event):  # pragma: no cover - real Qt only
        try:
            self.click(event.position().x())
        except Exception:
            pass

    def mouseMoveEvent(self, event):  # pragma: no cover - real Qt only
        try:
            self.hover(event.position().x())
        except Exception:
            pass

    # ---- rendering -------------------------------------------------------
    def _render(self) -> None:
        img = np.zeros((self.H, self.W, 3), np.uint8)
        img[:] = (18, 20, 26)
        ph = self.H - _MARGIN_T - _MARGIN_B
        # axes
        img[self.H - _MARGIN_B, _MARGIN_L:] = (90, 96, 110)
        img[_MARGIN_T : self.H - _MARGIN_B + 1, _MARGIN_L] = (90, 96, 110)
        if len(self._mm):
            peak = max(float(self._mm.max()), 1e-9)
            # gridlines at quartiles (reference _draw_gridlines)
            for q in (0.25, 0.5, 0.75, 1.0):
                y = self.H - _MARGIN_B - int(ph * q)
                img[y, _MARGIN_L:] = (40, 44, 56)
            for p, v in zip(self._positions, self._mm):
                x = self._x_of(int(p))
                bar = int(round(ph * v / peak))
                if bar:
                    img[self.H - _MARGIN_B - bar : self.H - _MARGIN_B, max(x - 1, _MARGIN_L) : x + 2] = (
                        86, 156, 214,
                    )
        if self._cursor is not None and self._max_position:
            x = min(self._x_of(self._cursor), self.W - 1)
            img[_MARGIN_T : self.H - _MARGIN_B, x] = (220, 163, 86)
        self._chart = img
        self.canvas.setPixmap(to_pixmap(img))

    @property
    def chart_array(self) -> np.ndarray:
        return self._chart
