"""Calibration-quality inspector: reprojection / rigidity / scale tabs.

Port of caliscope_tpu/gui/widgets/quality_tabs.py.

Parity: reference gui/widgets/calibration_quality_tabs.py (+
scale_detail_dialog.py, distance_sparkline.py) — per-camera RMSE table,
error histogram strip, constraint-rigidity detail, scale-cue agreement.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.qt import (
    QLabel,
    QTableWidget,
    QTableWidgetItem,
    QTabWidget,
    QVBoxLayout,
    QWidget,
    QPushButton,
)
from caliscope_tpu_torch.gui.rendering import colorize, to_pixmap


class DistanceSparkline(QLabel):
    """Tiny inline histogram of reprojection errors (reference
    distance_sparkline.py renders with QPainter; this rasterizes to numpy)."""

    def __init__(self, parent=None, width: int = 320, height: int = 48):
        super().__init__(parent)
        self._w, self._h = width, height
        self.bin_counts: np.ndarray = np.zeros(0)

    def set_errors(self, errors: np.ndarray, n_bins: int = 48) -> None:
        errors = np.asarray(errors)
        if len(errors) == 0:
            self.bin_counts = np.zeros(0)
            self.setPixmap(to_pixmap(np.zeros((self._h, self._w, 3), np.uint8)))
            return
        hi = max(float(np.percentile(errors, 99)), 1e-6)
        hist, _ = np.histogram(errors, bins=n_bins, range=(0.0, hi))
        self.bin_counts = hist
        img = np.zeros((self._h, self._w, 3), np.uint8)
        img[:] = (18, 20, 26)
        peak = hist.max()
        bw = self._w // n_bins
        for i, c in enumerate(hist):
            bar = 0 if peak == 0 else int(round((self._h - 2) * c / peak))
            if bar:
                color = colorize(np.array([[i / n_bins]]))[0, 0]
                img[self._h - bar :, i * bw : (i + 1) * bw] = color
        self.setPixmap(to_pixmap(img))


class CalibrationQualityTabs(QTabWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        # reprojection tab
        repro = QWidget()
        rl = QVBoxLayout(repro)
        self.summary = QLabel("No calibration yet.")
        self.summary.setWordWrap(True)
        rl.addWidget(self.summary)
        self.sparkline = DistanceSparkline()
        rl.addWidget(self.sparkline)
        self.rmse_table = QTableWidget(0, 3)
        self.rmse_table.setHorizontalHeaderLabels(["camera", "RMSE px", "unmatched"])
        rl.addWidget(self.rmse_table)
        self.addTab(repro, "Reprojection")

        # rigidity tab
        rigid = QWidget()
        gl = QVBoxLayout(rigid)
        self.rigidity_summary = QLabel("No constraints in play.")
        self.rigidity_summary.setWordWrap(True)
        gl.addWidget(self.rigidity_summary)
        self.rigidity_table = QTableWidget(0, 2)
        self.rigidity_table.setHorizontalHeaderLabels(["object", "RMSE mm"])
        gl.addWidget(self.rigidity_table)
        self.addTab(rigid, "Rigidity")

        # scale tab
        scale = QWidget()
        sl = QVBoxLayout(scale)
        self.scale_summary = QLabel("No scale cues.")
        self.scale_summary.setWordWrap(True)
        sl.addWidget(self.scale_summary)
        self.scale_chart = ScaleDetailChart()
        sl.addWidget(self.scale_chart)
        self.detail_btn = QPushButton("Details…")
        self.detail_btn.clicked.connect(self.open_scale_detail)
        sl.addWidget(self.detail_btn)
        self.addTab(scale, "Scale")
        self._scale_report = None
        self.scale_dialog = None

    def update_from_volume(self, volume) -> None:
        rep = volume.reprojection_report
        self.summary.setText(rep.summary())
        self.sparkline.set_errors(rep.raw_errors.euclidean_error)
        by_cam = sorted(rep.by_camera.items())
        self.rmse_table.setRowCount(len(by_cam))
        for i, (cid, rmse) in enumerate(by_cam):
            self.rmse_table.setItem(i, 0, QTableWidgetItem(str(cid)))
            self.rmse_table.setItem(i, 1, QTableWidgetItem(f"{rmse:.3f}"))
            self.rmse_table.setItem(i, 2, QTableWidgetItem(str(rep.unmatched_by_camera.get(cid, 0))))

        if volume.constraints is not None:
            rr = volume.rigidity_report()
            if rr.n_violations:
                self.rigidity_summary.setText(
                    f"{rr.n_violations} constrained distances: RMSE {rr.rmse_mm:.2f} mm "
                    f"({rr.relative_rmse_pct:.2f}%), worst {rr.max_violation_mm:.2f} mm"
                )
                per_obj = sorted(rr.per_object_rmse_mm.items())
                self.rigidity_table.setRowCount(len(per_obj))
                for i, (oid, mm) in enumerate(per_obj):
                    self.rigidity_table.setItem(i, 0, QTableWidgetItem(str(oid)))
                    self.rigidity_table.setItem(i, 1, QTableWidgetItem(f"{mm:.2f}"))
            else:
                self.rigidity_summary.setText("Constraints present, none measurable yet.")
        else:
            self.rigidity_summary.setText("No constraints in play.")

        sr = volume.compute_volumetric_scale_accuracy()
        self._scale_report = sr
        self.scale_chart.set_report(sr)
        if self.scale_dialog is not None:
            self.scale_dialog.set_data(sr, sorted({fe.sync_index for fe in sr.frame_errors}))
        if sr.n_frames_sampled:
            worst = sr.worst_frame
            self.scale_summary.setText(
                f"Volumetric scale over {sr.n_frames_sampled} frames: pooled RMSE "
                f"{sr.pooled_rmse_mm:.2f} mm, median {sr.median_rmse_mm:.2f} mm, bias "
                f"{sr.mean_signed_error_mm:+.2f} mm; worst frame sync {worst.sync_index} "
                f"({worst.distance_rmse_mm:.2f} mm)"
            )
        else:
            self.scale_summary.setText("No scale cues (no known-geometry targets observed).")

    def open_scale_detail(self):
        """Open (or refresh) the standalone scale-accuracy detail dialog
        (reference scale_detail_dialog.py): expanded chart with axes +
        summary statistics + the per-frame table."""
        from caliscope_tpu_torch.gui.widgets.scale_detail_dialog import ScaleDetailDialog

        if self.scale_dialog is None:
            self.scale_dialog = ScaleDetailDialog(self)
        if self._scale_report is not None:
            syncs = sorted({fe.sync_index for fe in self._scale_report.frame_errors})
            self.scale_dialog.set_data(self._scale_report, syncs)
        if hasattr(self.scale_dialog, "show"):
            self.scale_dialog.show()
        return self.scale_dialog


class ScaleDetailChart(QLabel):
    """Expanded per-frame scale-accuracy chart (reference
    scale_detail_dialog.py renders with QPainter; this rasterizes to numpy).

    Area chart of per-frame distance RMSE (mm) over the frame slider's
    position domain, with a vertical cursor and click-to-seek: clicking a
    column emits `frame_clicked(sync_index)`. `frame_at(x)` / `value_at(x)`
    expose the hover data (the real-Qt tooltip and the tests share them).
    """

    def __init__(self, parent=None, width: int = 560, height: int = 180):
        super().__init__(parent)
        self._w, self._h = width, height
        self._sync: np.ndarray = np.zeros(0, int)
        self._mm: np.ndarray = np.zeros(0)
        self._cursor: int | None = None
        self.frame_clicked = _make_signal()

    def set_report(self, report) -> None:
        """report: VolumetricScaleReport; one column per sampled frame."""
        frames = sorted(report.frame_errors, key=lambda fe: fe.sync_index)
        self._sync = np.array([fe.sync_index for fe in frames], int)
        self._mm = np.array([fe.distance_rmse_mm for fe in frames])
        self._render()

    def set_cursor(self, sync_index: int | None) -> None:
        self._cursor = sync_index
        self._render()

    # ---- hover/click data (shared by real-Qt events and headless tests) ----
    def frame_at(self, x: int) -> int | None:
        if len(self._sync) == 0 or not (0 <= x < self._w):
            return None
        i = min(int(x * len(self._sync) / self._w), len(self._sync) - 1)
        return int(self._sync[i])

    def value_at(self, x: int) -> float | None:
        if len(self._mm) == 0 or not (0 <= x < self._w):
            return None
        i = min(int(x * len(self._mm) / self._w), len(self._mm) - 1)
        return float(self._mm[i])

    def click(self, x: int) -> None:
        """Programmatic click-to-seek (mousePressEvent routes here)."""
        f = self.frame_at(x)
        if f is not None:
            self.frame_clicked.emit(f)

    def mousePressEvent(self, event):  # pragma: no cover - real Qt only
        try:
            self.click(int(event.position().x()))
        except Exception:
            pass

    def _render(self) -> None:
        img = np.zeros((self._h, self._w, 3), np.uint8)
        img[:] = (18, 20, 26)
        n = len(self._mm)
        if n:
            # horizontal gridlines at quartiles of the value range
            peak = max(float(self._mm.max()), 1e-9)
            for q in (0.25, 0.5, 0.75):
                y = self._h - 1 - int((self._h - 12) * q)
                img[y, :] = (40, 44, 56)
            col_w = max(self._w // n, 1)
            for i, v in enumerate(self._mm):
                bar = int(round((self._h - 12) * v / peak))
                x0 = i * self._w // n
                x1 = min(x0 + col_w, self._w)
                if bar:
                    img[self._h - bar :, x0:x1] = (86, 156, 214)
            if self._cursor is not None and self._cursor in set(self._sync.tolist()):
                i = int(np.where(self._sync == self._cursor)[0][0])
                x = min(i * self._w // n + col_w // 2, self._w - 1)
                img[:, x] = (220, 163, 86)
        self._chart = img
        self.setPixmap(to_pixmap(img))

    @property
    def chart_array(self) -> np.ndarray:
        """Rendered RGB array (headless-assertable)."""
        return getattr(self, "_chart", np.zeros((self._h, self._w, 3), np.uint8))


def _make_signal():
    """A tiny connect/emit signal that works under real Qt and headless."""

    class _Sig:
        def __init__(self):
            self._subs = []

        def connect(self, fn):
            self._subs.append(fn)

        def emit(self, *a):
            for fn in list(self._subs):
                fn(*a)

    return _Sig()
