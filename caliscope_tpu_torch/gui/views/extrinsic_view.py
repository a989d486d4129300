"""Extrinsics tab: calibration, quality inspection, filtering, anchoring,
3D playback.

Port of caliscope_tpu/gui/views/extrinsic_view.py.

Parity: reference gui/views/extrinsic_calibration_view.py (~880 LoC) bound
to ExtrinsicCalibrationPresenter: run calibration with progress, the
filter-preview slider (percent-above-threshold readout before committing a
re-optimize), origin operations (gravity/ground/center/align-to-marker,
axis rotations), the calibration-quality tabs, and the 3D volume playback.
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QCheckBox,
    QComboBox,
    QGridLayout,
    QGroupBox,
    QHBoxLayout,
    QLabel,
    QMessageBox,
    QProgressBar,
    QPushButton,
    QSlider,
    Qt,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.widgets import CalibrationQualityTabs, Playback3DWidget


class ExtrinsicCalibrationView(QWidget):
    def __init__(self, window, parent=None):
        super().__init__(parent)
        self.window = window
        self.presenter = None
        layout = QVBoxLayout(self)

        row = QHBoxLayout()
        self.refine_box = QCheckBox("Refine intrinsics")
        self.refine_box.setChecked(True)
        row.addWidget(self.refine_box)
        self.calib_btn = QPushButton("Calibrate")
        self.calib_btn.clicked.connect(self.calibrate)
        row.addWidget(self.calib_btn)
        self.summary = QLabel("")
        self.summary.setWordWrap(True)
        row.addWidget(self.summary)
        layout.addLayout(row)

        self.progress = QProgressBar()
        layout.addWidget(self.progress)

        self.quality = CalibrationQualityTabs()
        layout.addWidget(self.quality)

        # ---- filter preview (slider BEFORE committing the re-optimize) -----
        filt = QGroupBox("Outlier filter")
        fl = QGridLayout(filt)
        fl.addWidget(QLabel("Percentile:"), 0, 0)
        self.pct_slider = QSlider(Qt.Horizontal)
        self.pct_slider.setRange(0, 100)  # tenths of a percent: 0.0 - 10.0%
        self.pct_slider.setValue(25)
        self.pct_slider.valueChanged.connect(lambda _v: self._update_filter_preview())
        fl.addWidget(self.pct_slider, 0, 1)
        self.filter_preview = QLabel("")
        fl.addWidget(self.filter_preview, 1, 0)
        self.filter_btn = QPushButton("Filter + re-optimize")
        self.filter_btn.clicked.connect(self.filter_points)
        fl.addWidget(self.filter_btn, 1, 1)
        layout.addWidget(filt)

        # ---- origin / anchoring operations ---------------------------------
        ops = QGroupBox("Origin / anchoring")
        grid = QGridLayout(ops)
        for col, (label, fn) in enumerate(
            [
                ("Orient (gravity up)", self.orient),
                ("Ground (floor z=0)", self.ground),
                ("Center", self.center),
            ]
        ):
            b = QPushButton(label)
            b.clicked.connect(fn)
            grid.addWidget(b, 0, col)
        grid.addWidget(QLabel("Align to:"), 1, 0)
        self.origin_box = QComboBox()
        grid.addWidget(self.origin_box, 1, 1)
        align_btn = QPushButton("Align")
        align_btn.clicked.connect(self.align_to_origin)
        grid.addWidget(align_btn, 1, 2)
        grid.addWidget(QLabel("Rotate:"), 2, 0)
        rot_row = QHBoxLayout()
        for axis in ("x", "y", "z"):
            for deg in (-90, 90):
                b = QPushButton(f"{axis}{deg:+d}°")
                b.clicked.connect(lambda a=axis, d=deg: self.rotate(a, d))
                rot_row.addWidget(b)
        rot_host = QWidget()
        rot_host.setLayout(rot_row)
        grid.addWidget(rot_host, 2, 1)
        layout.addWidget(ops)

        self.playback = Playback3DWidget()
        layout.addWidget(self.playback)
        layout.addStretch(1)

        self.bridge = SignalBridge(self.on_event)

    # ---- calibration ----------------------------------------------------------
    def refresh(self) -> None:
        ws = self.window.ws
        if ws is None or self.presenter is not None:
            return
        if ws.capture_volume.exists():
            from caliscope_tpu_torch.presenters import ExtrinsicCalibrationPresenter

            # rebuild a presenter around the saved volume so quality/origin
            # operations work after reopening a project
            p = ExtrinsicCalibrationPresenter(None, None, ws.make_extrinsic_constraints(), device=ws.device)
            from caliscope_tpu_torch.pipelines import CalibrationRun

            vol = ws.capture_volume.load(device=ws.device)
            p._run = CalibrationRun(
                capture_volume=vol,
                intrinsic_estimates=(),
                synthesized_cam_ids=frozenset(),
                dropped_static_markers=(),
                intrinsic_refinement_gated=False,
            )
            self._wire(p)
            self.presenter = p
            self._show_volume(vol)

    def _wire(self, p) -> None:
        self.bridge.bind(p.progress_updated, "progress")
        self.bridge.bind(p.capture_volume_changed, "volume")
        self.bridge.bind(p.error_occurred, "error")

    def calibrate(self) -> None:
        ws = self.window.ws
        if ws is None:
            return
        from caliscope_tpu_torch.observations import ImagePoints
        from caliscope_tpu_torch.presenters import ExtrinsicCalibrationPresenter

        csv = ws.xy_csv_path(ws.targets.get_extrinsic_tracker_name())
        if not csv.exists():
            QMessageBox.warning(self, "No extraction", "Run extraction first.")
            return
        points = ImagePoints.from_csv(csv)
        cameras = ws.ensure_cameras_from_videos() if not ws.cameras.exists() else ws.cameras.load()
        p = ExtrinsicCalibrationPresenter(points, cameras, ws.make_extrinsic_constraints(), device=ws.device)
        p.set_refine_intrinsics(self.refine_box.isChecked())
        self._wire(p)
        self.presenter = p
        self.calib_btn.setEnabled(False)
        self.summary.setText("Calibrating…")
        p.run_calibration(filter_percentile=self.pct_slider.value() / 10.0)

    # ---- filter preview -------------------------------------------------------
    def _update_filter_preview(self) -> None:
        p = self.presenter
        if p is None or p.capture_volume is None:
            return
        pct = self.pct_slider.value() / 10.0
        preview = p.get_filter_preview()
        thr = preview.percentile_error(100.0 - pct)
        self.filter_preview.setText(
            f"drop worst {pct:.1f}% = errors above {thr:.2f} px "
            f"({preview.percent_above_threshold(thr):.1f}% of observations)"
        )

    def filter_points(self) -> None:
        self._with_volume(lambda p: p.filter_by_percentile(self.pct_slider.value() / 10.0))

    # ---- origin operations ------------------------------------------------------
    def _with_volume(self, fn) -> None:
        p = self.presenter
        if p is None or p.capture_volume is None:
            return
        try:
            fn(p)
        except Exception as e:  # surface, don't crash the GUI
            self.summary.setText(f"Error: {e}")

    def orient(self) -> None:
        self._with_volume(lambda p: p.orient_gravity())

    def ground(self) -> None:
        self._with_volume(lambda p: p.ground())

    def center(self) -> None:
        self._with_volume(lambda p: p.center())

    def rotate(self, axis: str, degrees: float) -> None:
        self._with_volume(lambda p: p.rotate(axis, degrees))

    def align_to_origin(self) -> None:
        p = self.presenter
        if p is None or self.origin_box.currentData() is None:
            return
        object_id, sync_index = self.origin_box.currentData()
        self._with_volume(lambda pp: pp.align_to_origin(object_id, sync_index))

    def _refresh_origin_options(self) -> None:
        p = self.presenter
        self.origin_box.clear()
        if p is None:
            return
        for opt in p.get_origin_options():
            self.origin_box.addItem(opt.label, (opt.object_id, opt.sync_index))

    # ---- events -----------------------------------------------------------------
    def _show_volume(self, vol) -> None:
        rep = vol.reprojection_report
        self.summary.setText(
            f"RMSE {rep.overall_rmse:.3f} px over {rep.n_observations_matched} observations, "
            f"{rep.n_cameras} cameras posed."
        )
        self.quality.update_from_volume(vol)
        self.playback.set_volume(vol)
        self._refresh_origin_options()
        self._update_filter_preview()

    def on_event(self, name, args) -> None:
        if name == "progress" and len(args) >= 2:
            self.progress.setMaximum(100)
            self.progress.setValue(int(args[0]))
        elif name == "volume":
            vol = args[0]
            self._show_volume(vol)
            ws = self.window.ws
            ws.capture_volume.save(vol)
            ws.cameras.save(vol.camera_array)
            self.calib_btn.setEnabled(True)
            self.window.refresh_tabs()
        elif name == "error":
            self.summary.setText(f"Error: {args[0]}")
            self.calib_btn.setEnabled(True)
