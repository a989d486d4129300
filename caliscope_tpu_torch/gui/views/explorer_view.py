"""Synthetic Calibration Explorer tab.

Port of caliscope_tpu/gui/views/explorer_view.py.

Parity: reference synthetic/explorer/explorer_tab.py + widgets/ — preset
selector, Run Pipeline, per-camera error metrics (rotation/translation/
RMSE vs ground truth), and the 4-panel storyboard (ground truth /
bootstrapped / optimized / aligned) with a frame scrub slider. Panels
render with the software Scene3DRenderer, so every panel is assertable in
headless tests.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QComboBox,
    QDoubleSpinBox,
    QGridLayout,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSlider,
    Qt,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.rendering import Scene3DRenderer, to_pixmap
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX
from caliscope_tpu_torch.synthetic.explorer import ExplorerPresenter

PANELS = ("ground_truth", "bootstrapped", "optimized", "aligned")


class ExplorerView(QWidget):
    def __init__(self, parent=None, device=None):
        super().__init__(parent)
        self.presenter = ExplorerPresenter(device=device)
        layout = QVBoxLayout(self)

        row = QHBoxLayout()
        row.addWidget(QLabel("Preset:"))
        self.preset_box = QComboBox()
        for p in self.presenter.presets:
            self.preset_box.addItem(p.label, p.key)
        row.addWidget(self.preset_box)
        row.addWidget(QLabel("Noise px:"))
        self.noise_box = QDoubleSpinBox()
        self.noise_box.setRange(0.0, 5.0)
        self.noise_box.setSingleStep(0.1)
        self.noise_box.setValue(0.5)
        row.addWidget(self.noise_box)
        self.run_btn = QPushButton("Run pipeline")
        self.run_btn.clicked.connect(self.run)
        row.addWidget(self.run_btn)
        self.status = QLabel("")
        row.addWidget(self.status)
        layout.addLayout(row)

        grid_host = QWidget()
        grid = QGridLayout(grid_host)
        self.panels: dict[str, QLabel] = {}
        for i, name in enumerate(PANELS):
            cell = QVBoxLayout()
            title = QLabel(name.replace("_", " "))
            canvas = QLabel()
            cell.addWidget(title)
            cell.addWidget(canvas)
            host = QWidget()
            host.setLayout(cell)
            grid.addWidget(host, i // 2, i % 2)
            self.panels[name] = canvas
        layout.addWidget(grid_host)

        self.slider = QSlider(Qt.Horizontal)
        self.slider.valueChanged.connect(lambda _v: self._render_panels())
        layout.addWidget(self.slider)

        self.metrics_table = QTableWidget(0, 4)
        self.metrics_table.setHorizontalHeaderLabels(["cam", "rot err °", "trans err m", "RMSE px"])
        layout.addWidget(self.metrics_table)
        layout.addStretch(1)

        self.renderer = Scene3DRenderer(300, 220)
        self._bridge = SignalBridge(self._on_event)
        self._bridge.bind(self.presenter.pipeline_finished, "finished")
        self._bridge.bind(self.presenter.pipeline_failed, "failed")

    # ---- actions --------------------------------------------------------------
    def run(self) -> None:
        key = self.preset_box.currentData()
        self.presenter.select_preset(key, noise_sigma_px=self.noise_box.value())
        self.run_btn.setEnabled(False)
        self.status.setText("Running bootstrap → optimize → align…")
        self.presenter.run_pipeline()

    # ---- rendering -------------------------------------------------------------
    def _sync_indices(self) -> np.ndarray:
        scene = self.presenter.scene
        if scene is None:
            return np.zeros(0, int)
        result = self.presenter.result
        if result and result.stage_volumes.get("aligned") is not None:
            wp = result.stage_volumes["aligned"].world_points
            return np.unique(wp.sync_index[wp.sync_index != STATIC_SYNC_INDEX]).astype(int)
        return np.zeros(0, int)

    def _render_panels(self) -> None:
        result = self.presenter.result
        scene = self.presenter.scene
        if result is None or scene is None or result.error:
            return
        syncs = self._sync_indices()
        sync = int(syncs[min(self.slider.value(), len(syncs) - 1)]) if len(syncs) else None
        # frame the virtual camera around the ground-truth rig
        centers = np.stack(
            [-c.rotation.T @ c.translation.reshape(3) for c in scene.cameras.cameras.values()]
        )
        self.renderer.target = centers.mean(axis=0) * 0.3
        self.renderer.distance = float(np.linalg.norm(centers.std(axis=0))) * 4 + 2.0
        for name in PANELS:
            if name == "ground_truth":
                vol = result.stage_volumes.get("aligned")
                cams = scene.cameras
                xyz = vol.world_points.xyz if vol else np.zeros((0, 3))
            else:
                vol = result.stage_volumes.get(name)
                if vol is None:
                    continue
                cams = vol.camera_array
                xyz = vol.world_points.xyz
            wp = vol.world_points if vol else None
            highlight = xyz[wp.sync_index == sync] if (wp is not None and sync is not None) else None
            img = self.renderer.render(xyz, cams, highlight)
            self.panels[name].setPixmap(to_pixmap(img))

    # ---- events -----------------------------------------------------------------
    def _on_event(self, name, args) -> None:
        self.run_btn.setEnabled(True)
        if name == "failed":
            self.status.setText(f"Error: {args[0]}")
            return
        result = args[0]
        self.status.setText(
            f"RMSE {result.reprojection_rmse:.3f} px; worst camera "
            f"{result.max_rotation_error_deg:.3f}° / {result.max_translation_error_m * 1000:.1f} mm vs truth"
        )
        metrics = result.camera_metrics
        self.metrics_table.setRowCount(len(metrics))
        for i, m in enumerate(metrics):
            self.metrics_table.setItem(i, 0, QTableWidgetItem(str(m.cam_id)))
            self.metrics_table.setItem(i, 1, QTableWidgetItem(f"{m.rotation_error_deg:.4f}"))
            self.metrics_table.setItem(i, 2, QTableWidgetItem(f"{m.translation_error_m * 1000:.2f}"))
            self.metrics_table.setItem(i, 3, QTableWidgetItem(f"{m.reprojection_rmse:.3f}"))
        syncs = self._sync_indices()
        self.slider.setRange(0, max(len(syncs) - 1, 0))
        self._render_panels()
