"""Cameras tab: camera-list sidebar + pooled per-camera calibration panels.

Port of caliscope_tpu/gui/views/cameras_tab.py.

Parity: reference src/caliscope/gui/cameras_tab_widget.py:1 — a splitter
with a CameraListWidget sidebar (status glyphs + RMSE), a calibration
pattern preview and a global frame-skip control on the left; per-camera
calibration workflow panels on the right. Panels and presenters are POOLED:
switching cameras hides the current panel but keeps its presenter running
(background calibration continues), and completed calibrations refresh the
sidebar status. Live tracked-frame playback runs on a FrameRenderThread
fed by the presenter's display queue (reference
gui/views/intrinsic_calibration_widget.py:341).
"""

from __future__ import annotations

import logging

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSpinBox,
    QSplitter,
    Qt,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.rendering import to_pixmap
from caliscope_tpu_torch.gui.theme import Styles, Typography
from caliscope_tpu_torch.gui.widgets.camera_list import CameraListWidget

logger = logging.getLogger(__name__)


class CameraPanel(QWidget):
    """One camera's calibration workflow: live view + run + quality readout."""

    def __init__(self, tab: "CamerasTabWidget", cam_id: int, parent=None):
        super().__init__(parent)
        self.tab = tab
        self.cam_id = cam_id
        self.presenter = None
        self.render_thread = None
        self.render_error: str | None = None  # the live view's failure, kept on the panel
        self._bridge = SignalBridge(self._on_event)

        layout = QVBoxLayout(self)
        self.video_label = QLabel(f"Camera {cam_id}")
        self.video_label.setStyleSheet(Styles.PANEL)
        layout.addWidget(self.video_label)

        row = QHBoxLayout()
        self.run_btn = QPushButton("Calibrate")
        self.run_btn.setStyleSheet(Styles.PRIMARY_BUTTON)
        self.run_btn.clicked.connect(self.run)
        row.addWidget(self.run_btn)
        self.status_label = QLabel("")
        row.addWidget(self.status_label)
        layout.addLayout(row)

        from caliscope_tpu_torch.gui.widgets import CoverageHeatmapWidget, LensModelWidget

        self.lens = LensModelWidget()
        layout.addWidget(self.lens)
        self.heatmap = CoverageHeatmapWidget()
        layout.addWidget(self.heatmap)
        layout.addStretch(1)
        self.show_existing()

    # ---- existing state ------------------------------------------------------
    def show_existing(self) -> None:
        ws = self.tab.workspace
        if ws is None or not ws.cameras.exists():
            return
        cam = ws.cameras.load().cameras.get(self.cam_id)
        if cam is not None and cam.matrix is not None:
            self.lens.update_from_camera(cam)
            report = ws.intrinsic_reports.load(self.cam_id)
            if report is not None:
                self.status_label.setText(
                    f"RMSE {report.rmse:.3f} px over {report.frames_used} frames"
                )
                self.status_label.setStyleSheet(Typography.STATUS_OK)

    # ---- calibration run -----------------------------------------------------
    def run(self) -> None:
        ws = self.tab.workspace
        if ws is None or self.presenter is not None:
            return
        video = ws.video_path("intrinsic", self.cam_id)
        if not video.exists():
            self.status_label.setText(f"No intrinsic video at {video}")
            self.status_label.setStyleSheet(Typography.STATUS_ERROR)
            return
        from caliscope_tpu_torch.cameras import CameraArray, CameraData
        from caliscope_tpu_torch.gui.frame_render import FrameRenderThread, make_display_queue
        from caliscope_tpu_torch.media import read_video_properties
        from caliscope_tpu_torch.presenters import IntrinsicCalibrationPresenter

        array = ws.cameras.load() if ws.cameras.exists() else CameraArray({})
        cam = array.cameras.get(self.cam_id)
        if cam is None:
            cam = CameraData(cam_id=self.cam_id, size=read_video_properties(video).size)
        q = make_display_queue()
        self.render_error = None
        self.presenter = IntrinsicCalibrationPresenter(
            cam,
            video,
            ws.make_intrinsic_tracker(),
            frame_step=self.tab.frame_skip,
            display_queue=q,
            device=ws.device,
        )
        self.render_thread = FrameRenderThread(q, cam, device=ws.device)
        self.render_thread.connect_to_label(self.video_label)
        self.render_thread.error_occurred.connect(self._on_render_error)
        self._bridge.bind(self.presenter.calibration_completed, "done")
        self._bridge.bind(self.presenter.error_occurred, "error")
        self.run_btn.setEnabled(False)
        self.status_label.setText("Calibrating…")
        self.render_thread.start()
        self.presenter.run()

    def _on_event(self, name, args) -> None:
        if name == "done":
            out = args[0]
            cam = out.camera
            self.status_label.setText(
                f"fx={cam.matrix[0, 0]:.1f} fy={cam.matrix[1, 1]:.1f} "
                f"RMSE={out.report.rmse:.3f}px coverage={out.report.coverage_fraction:.0%}"
            )
            self.status_label.setStyleSheet(Typography.STATUS_OK)
            self.lens.update_from_camera(cam)
            points = getattr(self.presenter, "_points", None)
            if points is not None:
                self.heatmap.set_data(points, {cam.cam_id: cam.size})
            self.tab.on_calibration_complete(self.cam_id, out)
        elif name == "error":
            self.status_label.setText(f"Error: {args[0]}")
            self.status_label.setStyleSheet(Typography.STATUS_ERROR)
        if self.render_error is not None:
            # the live view failed during the run: the result does not hide it
            self.status_label.setText(f"{self.status_label.text()} | Display error: {self.render_error}")
            self.status_label.setStyleSheet(Typography.STATUS_ERROR)
        self.run_btn.setEnabled(True)
        self._stop_render()
        self.presenter = None

    def _on_render_error(self, message: str) -> None:
        self.render_error = message
        self.status_label.setText(f"Display error: {message}")
        self.status_label.setStyleSheet(Typography.STATUS_ERROR)

    def _stop_render(self) -> None:
        if self.render_thread is not None:
            self.render_thread.stop()
            self.render_thread.wait(2000)
            self.render_thread = None

    def cleanup(self) -> None:
        self._stop_render()


class CamerasTabWidget(QWidget):
    """Splitter container: camera list + pattern preview | pooled panels."""

    def __init__(self, window, parent=None):
        super().__init__(parent)
        self.window = window
        self._panels: dict[int, CameraPanel] = {}
        self._current_cam_id: int | None = None
        self.frame_skip = 5

        layout = QHBoxLayout(self)
        self.splitter = QSplitter(Qt.Horizontal)

        # left: list + pattern preview + frame-skip
        left = QWidget()
        left_layout = QVBoxLayout(left)
        from caliscope_tpu_torch.cameras import CameraArray

        array = self._camera_array() or CameraArray({})
        self.camera_list = CameraListWidget(array)
        self.camera_list.setMinimumWidth(150)
        self.camera_list.camera_selected.connect(self._on_camera_selected)
        left_layout.addWidget(self.camera_list)

        self.pattern_preview = QLabel()
        self.pattern_preview.setStyleSheet(Styles.PANEL)
        left_layout.addWidget(self.pattern_preview)
        self.pattern_info = QLabel("")
        self.pattern_info.setStyleSheet(Typography.SECTION_HEADER)
        left_layout.addWidget(self.pattern_info)

        left_layout.addWidget(QLabel("Process every Nth frame:"))
        self.frame_skip_spin = QSpinBox()
        self.frame_skip_spin.setRange(1, 100000)
        self.frame_skip_spin.setValue(self.frame_skip)
        self.frame_skip_spin.valueChanged.connect(self._on_frame_skip_changed)
        left_layout.addWidget(self.frame_skip_spin)
        left_layout.addStretch(1)
        self.splitter.addWidget(left)

        # right: content area with pooled panels
        self.content = QWidget()
        self.content_layout = QVBoxLayout(self.content)
        self.message_label = QLabel("Select a camera to begin calibration")
        self.content_layout.addWidget(self.message_label)
        self.splitter.addWidget(self.content)

        layout.addWidget(self.splitter)
        self._update_pattern_preview()
        if self.camera_list.count() > 0:
            self.camera_list.setCurrentRow(0)
        else:
            # explain the supported no-intrinsic-videos path instead of
            # presenting a dead tab (reference cameras_info_placeholder.py)
            from caliscope_tpu_torch.gui.widgets.cameras_placeholder import CamerasInfoPlaceholder

            self.message_label.hide()
            self.placeholder = CamerasInfoPlaceholder()
            self.content_layout.addWidget(self.placeholder)

    # ---- workspace plumbing --------------------------------------------------
    @property
    def workspace(self):
        return getattr(self.window, "ws", None)

    def _camera_array(self):
        ws = self.workspace
        if ws is None:
            return None
        from caliscope_tpu_torch.cameras import CameraArray, CameraData

        cams = dict(ws.cameras.load().cameras) if ws.cameras.exists() else {}
        # the cameras tab's job is INTRINSIC calibration, so cameras with an
        # intrinsic video but no saved calibration must still get a row
        # (get_cam_ids alone is the extrinsic set)
        known = set(cams) | set(ws._cam_ids_in_dir(ws.intrinsic_dir)) | set(ws.get_cam_ids())
        for cid in known - set(cams):
            cams[cid] = CameraData(cam_id=cid, size=None)
        return CameraArray(cams)

    def _update_pattern_preview(self) -> None:
        ws = self.workspace
        if ws is None:
            return
        try:
            charuco = ws.targets.load_intrinsic_charuco()
        except Exception:
            self.pattern_info.setText("No calibration target configured")
            return
        board = charuco.board_image(px_per_square=24, margin_squares=0.25)
        import numpy as np

        rgb = np.repeat(board[:, :, None], 3, axis=2).astype(np.uint8)
        self.pattern_preview.setPixmap(to_pixmap(rgb))
        self.pattern_info.setText(f"ChArUco: {charuco.columns} x {charuco.rows}")

    # ---- interactions --------------------------------------------------------
    def _on_frame_skip_changed(self, value: int) -> None:
        self.frame_skip = int(value)
        for panel in self._panels.values():
            if panel.presenter is not None:
                panel.presenter.frame_step = self.frame_skip

    def _on_camera_selected(self, cam_id: int) -> None:
        if self._current_cam_id is not None and self._current_cam_id in self._panels:
            self._panels[self._current_cam_id].hide()
        if cam_id not in self._panels:
            self._panels[cam_id] = CameraPanel(self, cam_id)
            self.content_layout.addWidget(self._panels[cam_id])
        self.message_label.hide()
        self._panels[cam_id].show()
        self._current_cam_id = cam_id

    def on_calibration_complete(self, cam_id: int, output) -> None:
        ws = self.workspace
        if ws is not None:
            ws.cameras.save_camera(output.camera)
            ws.intrinsic_reports.save(cam_id, output.report)
            self.camera_list.refresh(self._camera_array())
            refresh = getattr(self.window, "refresh_tabs", None)
            if refresh:
                refresh()

    def refresh(self) -> None:
        array = self._camera_array()
        if array is not None:
            self.camera_list.refresh(array)
        self._update_pattern_preview()
        for panel in self._panels.values():
            panel.show_existing()

    def cleanup(self) -> None:
        for panel in self._panels.values():
            panel.cleanup()
        self._panels.clear()
        self._current_cam_id = None

    def closeEvent(self, event) -> None:
        self.cleanup()
        super().closeEvent(event)
