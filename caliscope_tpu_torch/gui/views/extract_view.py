"""Extract tab: run 2D point extraction over the extrinsic recordings and
inspect coverage before calibrating.

Port of caliscope_tpu/gui/views/extract_view.py.

Parity: reference gui/views/multi_camera_processing_widget.py (extraction
half) + structural warnings + per-camera observation table.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QHBoxLayout,
    QLabel,
    QProgressBar,
    QPushButton,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.widgets import StructuralWarningsWidget


class ExtractView(QWidget):
    def __init__(self, window, parent=None):
        super().__init__(parent)
        self.window = window
        layout = QVBoxLayout(self)

        row = QHBoxLayout()
        self.extract_btn = QPushButton("Extract 2D points")
        self.extract_btn.clicked.connect(self.extract)
        row.addWidget(self.extract_btn)
        self.status = QLabel("")
        row.addWidget(self.status)
        layout.addLayout(row)

        self.progress = QProgressBar()
        layout.addWidget(self.progress)

        self.obs_table = QTableWidget(0, 2)
        self.obs_table.setHorizontalHeaderLabels(["camera", "observations"])
        layout.addWidget(self.obs_table)

        self.warnings = StructuralWarningsWidget()
        layout.addWidget(self.warnings)
        layout.addStretch(1)

        self.bridge = SignalBridge(self.on_event)
        self.points = None

    def refresh(self) -> None:
        """Load a prior extraction from disk so reopening shows coverage."""
        ws = self.window.ws
        if ws is None:
            return
        try:
            csv = ws.xy_csv_path(ws.targets.get_extrinsic_tracker_name())
        except Exception:
            return
        if csv.exists():
            from caliscope_tpu_torch.observations import ImagePoints

            self._show_points(ImagePoints.from_csv(csv))

    def extract(self) -> None:
        ws = self.window.ws
        if ws is None:
            return
        from caliscope_tpu_torch.tasks import TaskManager

        self.extract_btn.setEnabled(False)
        self.status.setText("Extracting…")
        self.progress.setRange(0, 0)
        tm = getattr(self, "_tm", None) or TaskManager(max_workers=1)
        self._tm = tm

        handle = tm.submit(lambda: ws.extract_extrinsic_points(), name="extract")

        def on_done(fut):
            if fut.exception():
                self.bridge.relay.emit("error", (str(fut.exception()),))
            else:
                self.bridge.relay.emit("extracted", (fut.result(),))

        handle.future.add_done_callback(on_done)

    def _show_points(self, points) -> None:
        self.points = points
        cams, counts = np.unique(points.cam_id, return_counts=True)
        self.obs_table.setRowCount(len(cams))
        for i, (cid, n) in enumerate(zip(cams, counts)):
            self.obs_table.setItem(i, 0, QTableWidgetItem(str(int(cid))))
            self.obs_table.setItem(i, 1, QTableWidgetItem(str(int(n))))
        self.warnings.update_from_points(points)
        self.status.setText(f"{len(points)} observations across {len(cams)} cameras.")

    def on_event(self, name, args) -> None:
        self.progress.setRange(0, 1)
        self.progress.setValue(1)
        self.extract_btn.setEnabled(True)
        if name == "extracted":
            self._show_points(args[0])
            self.window.refresh_tabs()
        else:
            self.status.setText(f"Error: {args[0]}")
