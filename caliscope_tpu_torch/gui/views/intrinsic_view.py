"""Intrinsics tab: per-camera calibration with quality readout.

Port of caliscope_tpu/gui/views/intrinsic_view.py.

Parity: reference gui/views/intrinsic_calibration_widget.py (+ coverage
heatmap + lens visualizer) bound to IntrinsicCalibrationPresenter.
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QComboBox,
    QHBoxLayout,
    QLabel,
    QMessageBox,
    QProgressBar,
    QPushButton,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.widgets import CoverageHeatmapWidget, LensModelWidget


class IntrinsicCalibrationView(QWidget):
    def __init__(self, window, parent=None):
        super().__init__(parent)
        self.window = window
        self.presenter = None
        layout = QVBoxLayout(self)

        row = QHBoxLayout()
        row.addWidget(QLabel("Camera:"))
        self.cam_box = QComboBox()
        row.addWidget(self.cam_box)
        self.run_btn = QPushButton("Calibrate")
        self.run_btn.clicked.connect(self.run)
        row.addWidget(self.run_btn)
        layout.addLayout(row)

        from caliscope_tpu_torch.gui.widgets import CameraThumbnailCard

        self.camera_card = CameraThumbnailCard()
        layout.addWidget(self.camera_card)
        self.cam_box.currentTextChanged.connect(lambda _t: self._refresh_card())

        self.progress = QProgressBar()
        layout.addWidget(self.progress)
        self.result = QLabel("")
        self.result.setWordWrap(True)
        layout.addWidget(self.result)

        self.lens = LensModelWidget()
        layout.addWidget(self.lens)
        self.heatmap = CoverageHeatmapWidget()
        layout.addWidget(self.heatmap)
        layout.addStretch(1)

        self.bridge = SignalBridge(self.on_event)

    def refresh(self) -> None:
        self.cam_box.clear()
        ws = self.window.ws
        if ws:
            for cid in ws.get_cam_ids():
                self.cam_box.addItem(str(cid))
            self._refresh_card()
            self._show_existing()

    def _refresh_card(self) -> None:
        ws = self.window.ws
        if ws is not None and self.cam_box.currentText():
            self.camera_card.set_camera(ws, int(self.cam_box.currentText()))

    def _show_existing(self) -> None:
        """Surface already-calibrated intrinsics when reopening a project."""
        ws = self.window.ws
        if ws is None or not ws.cameras.exists() or not self.cam_box.currentText():
            return
        cam = ws.cameras.load().cameras.get(int(self.cam_box.currentText()))
        if cam is not None and cam.matrix is not None:
            self.lens.update_from_camera(cam)
            report = ws.intrinsic_reports.load(cam.cam_id)
            if report is not None:
                self.result.setText(
                    f"RMSE {report.rmse:.3f} px over {report.frames_used} frames, "
                    f"coverage {report.coverage_fraction:.0%}"
                )

    def run(self) -> None:
        ws = self.window.ws
        if ws is None or self.cam_box.currentText() == "":
            return
        cam_id = int(self.cam_box.currentText())
        from caliscope_tpu_torch.cameras import CameraArray, CameraData
        from caliscope_tpu_torch.media import read_video_properties
        from caliscope_tpu_torch.presenters import IntrinsicCalibrationPresenter

        video = ws.video_path("intrinsic", cam_id)
        if not video.exists():
            QMessageBox.warning(self, "Missing video", f"No intrinsic video at {video}")
            return
        array = ws.cameras.load() if ws.cameras.exists() else CameraArray({})
        cam = array.cameras.get(cam_id)
        if cam is None:
            props = read_video_properties(video)
            cam = CameraData(cam_id=cam_id, size=props.size)
        p = IntrinsicCalibrationPresenter(cam, video, ws.make_intrinsic_tracker(), device=ws.device)
        self.bridge.bind(p.calibration_completed, "done")
        self.bridge.bind(p.error_occurred, "error")
        self.presenter = p
        self.run_btn.setEnabled(False)
        self.progress.setRange(0, 0)  # busy indicator
        self.result.setText(f"Calibrating camera {cam_id}…")
        p.run()

    def _stop_busy(self) -> None:
        self.progress.setRange(0, 1)
        self.progress.setValue(1)

    def on_event(self, name, args) -> None:
        if name == "done":
            self._stop_busy()
            out = args[0]
            cam = out.camera
            self.result.setText(
                f"fx={cam.matrix[0, 0]:.1f} fy={cam.matrix[1, 1]:.1f} "
                f"cx={cam.matrix[0, 2]:.1f} cy={cam.matrix[1, 2]:.1f} "
                f"RMSE={out.report.rmse:.3f}px coverage={out.report.coverage_fraction:.0%}"
            )
            self.lens.update_from_camera(cam)
            points = getattr(self.presenter, "_points", None)
            if points is not None:
                self.heatmap.set_data(points, {cam.cam_id: cam.size})
            ws = self.window.ws
            ws.cameras.save_camera(cam)
            ws.intrinsic_reports.save(cam.cam_id, out.report)
            self.run_btn.setEnabled(True)
            self.window.refresh_tabs()
        elif name == "error":
            self._stop_busy()
            self.result.setText(f"Error: {args[0]}")
            self.run_btn.setEnabled(True)
