"""Project tab: workspace overview, workflow rows, camera table, target
configuration with per-stage routing.

Port of caliscope_tpu/gui/views/project_view.py.

Parity: reference gui/views/project_setup_view.py —
- per-stage workflow rows with detail text (WorkflowStepRow:63-156,
  _update_*_row:795-887) plus the compact strip;
- SEPARATE intrinsic and extrinsic target groups with target-type combos
  and the "extrinsic charuco same as intrinsic" checkbox, persisted
  through the targets repository's routing (config.toml — reference
  calibration_targets_repository.py:29-93);
- charuco dictionary-overflow validation with field revert
  (_render_charuco_or_warn:648, _revert_charuco_overflow:665 — lives in
  CharucoConfigPanel._apply/_revert_overflow);
- board image save (panels' "Save printable PNG" actions);
- camera table (camera_list_widget.py).
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.qt import (
    QCheckBox,
    QComboBox,
    QGroupBox,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.widgets import (
    ArucoSetPanel,
    CalibrationStepStrip,
    CharucoConfigPanel,
    ChessboardConfigPanel,
)
from caliscope_tpu_torch.gui.widgets.step_strip import WorkflowStepPanel
from caliscope_tpu_torch.repositories import TargetRouting
from caliscope_tpu_torch.targets import Charuco, Chessboard


class ProjectSetupView(QWidget):
    def __init__(self, window, parent=None):
        super().__init__(parent)
        self.window = window
        layout = QVBoxLayout(self)
        self.path_label = QLabel("No workspace open.")
        self.path_label.setWordWrap(True)
        layout.addWidget(self.path_label)

        self.step_strip = CalibrationStepStrip()
        layout.addWidget(self.step_strip)
        self.step_panel = WorkflowStepPanel()
        layout.addWidget(self.step_panel)

        self.cam_table = QTableWidget(0, 5)
        self.cam_table.setHorizontalHeaderLabels(["cam", "size", "fx", "error", "posed"])
        layout.addWidget(self.cam_table)

        # ---- intrinsic target group ------------------------------------
        self.intrinsic_group = QGroupBox("Intrinsic calibration target")
        il = QVBoxLayout(self.intrinsic_group)
        row = QHBoxLayout()
        row.addWidget(QLabel("Type:"))
        self.intrinsic_type = QComboBox()
        for t in ("charuco", "chessboard"):
            self.intrinsic_type.addItem(t)
        self.intrinsic_type.currentTextChanged.connect(lambda _t: self._save_routing())
        row.addWidget(self.intrinsic_type)
        il.addLayout(row)
        self.intrinsic_charuco_panel: CharucoConfigPanel | None = None
        self.chessboard_panel: ChessboardConfigPanel | None = None
        self._intrinsic_panel_slot = QVBoxLayout()
        il.addLayout(self._intrinsic_panel_slot)
        layout.addWidget(self.intrinsic_group)

        # ---- extrinsic target group ------------------------------------
        self.extrinsic_group = QGroupBox("Extrinsic calibration target")
        el = QVBoxLayout(self.extrinsic_group)
        row = QHBoxLayout()
        row.addWidget(QLabel("Type:"))
        self.extrinsic_type = QComboBox()
        for t in ("charuco", "aruco", "chessboard"):
            self.extrinsic_type.addItem(t)
        self.extrinsic_type.currentTextChanged.connect(lambda _t: self._save_routing())
        row.addWidget(self.extrinsic_type)
        self.same_as_intrinsic = QCheckBox("Same charuco as intrinsic")
        self.same_as_intrinsic.setChecked(True)
        self.same_as_intrinsic.stateChanged.connect(lambda _s: self._save_routing())
        row.addWidget(self.same_as_intrinsic)
        el.addLayout(row)
        self.extrinsic_charuco_panel: CharucoConfigPanel | None = None
        self.aruco_panel: ArucoSetPanel | None = None
        self._extrinsic_panel_slot = QVBoxLayout()
        el.addLayout(self._extrinsic_panel_slot)
        layout.addWidget(self.extrinsic_group)

        refresh = QPushButton("Refresh")
        refresh.clicked.connect(self.refresh)
        layout.addWidget(refresh)
        self._loading = False  # guard: combo initialization must not persist

    # ---- target panels -----------------------------------------------------
    def _build_target_panels(self, ws) -> None:
        routing = ws.targets.get_routing()
        self._loading = True
        try:
            self.intrinsic_type.setCurrentText(routing.intrinsic)
            self.extrinsic_type.setCurrentText(routing.extrinsic)
            self.same_as_intrinsic.setChecked(routing.extrinsic_charuco_same_as_intrinsic)
        finally:
            self._loading = False

        try:
            charuco = ws.targets.load_intrinsic_charuco()
        except Exception:
            charuco = Charuco(rows=4, columns=5, square_size_m=0.054)
        self.intrinsic_charuco_panel = CharucoConfigPanel(charuco)
        self.intrinsic_charuco_panel.target_changed.connect(self._save_intrinsic_charuco)
        self._intrinsic_panel_slot.addWidget(self.intrinsic_charuco_panel)

        try:
            chessboard = ws.targets.load_chessboard()
        except Exception:
            chessboard = Chessboard(rows=5, columns=7, square_size_m=0.03)
        self.chessboard_panel = ChessboardConfigPanel(chessboard)
        self.chessboard_panel.target_changed.connect(self._save_chessboard)
        self._intrinsic_panel_slot.addWidget(self.chessboard_panel)

        try:
            ext_ch = ws.targets.load_extrinsic_charuco()
        except Exception:
            ext_ch = charuco
        self.extrinsic_charuco_panel = CharucoConfigPanel(ext_ch)
        self.extrinsic_charuco_panel.target_changed.connect(self._save_extrinsic_charuco)
        self._extrinsic_panel_slot.addWidget(self.extrinsic_charuco_panel)

        try:
            ms = ws.targets.load_aruco_marker_set()
        except Exception:
            ms = None
        self.aruco_panel = ArucoSetPanel(ms)
        self.aruco_panel.target_changed.connect(self._save_aruco)
        self._extrinsic_panel_slot.addWidget(self.aruco_panel)
        self._update_panel_visibility()

    def _update_panel_visibility(self) -> None:
        """Show only the panels the routing selects (reference
        _update_extrinsic_stack:573 swaps a QStackedWidget; headless-safe
        visibility toggles carry the same state)."""
        it = self.intrinsic_type.currentText()
        if self.intrinsic_charuco_panel is not None:
            self.intrinsic_charuco_panel.setVisible(it == "charuco")
        if self.chessboard_panel is not None:
            self.chessboard_panel.setVisible(it == "chessboard")
        et = self.extrinsic_type.currentText()
        same = self.same_as_intrinsic.isChecked()
        if self.extrinsic_charuco_panel is not None:
            self.extrinsic_charuco_panel.setVisible(et == "charuco" and not same)
        if self.aruco_panel is not None:
            self.aruco_panel.setVisible(et == "aruco")
        self.same_as_intrinsic.setVisible(et == "charuco") if hasattr(self.same_as_intrinsic, "setVisible") else None

    # ---- persistence -------------------------------------------------------
    def _save_routing(self) -> None:
        ws = self.window.ws
        if ws is None or self._loading:
            return
        ws.targets.save_routing(
            TargetRouting(
                intrinsic=self.intrinsic_type.currentText(),
                extrinsic=self.extrinsic_type.currentText(),
                extrinsic_charuco_same_as_intrinsic=self.same_as_intrinsic.isChecked(),
            )
        )
        self._update_panel_visibility()

    def _save_intrinsic_charuco(self, ch) -> None:
        ws = self.window.ws
        if ws is not None:
            ws.targets.save_intrinsic_charuco(ch)

    def _save_extrinsic_charuco(self, ch) -> None:
        ws = self.window.ws
        if ws is not None:
            ws.targets.save_extrinsic_charuco(ch)

    def _save_chessboard(self, cb) -> None:
        ws = self.window.ws
        if ws is not None:
            ws.targets.save_chessboard(cb)

    def _save_aruco(self, ms) -> None:
        ws = self.window.ws
        if ws is not None:
            ws.targets.save_aruco_marker_set(ms)

    # ---- refresh -----------------------------------------------------------
    def refresh(self) -> None:
        ws = self.window.ws
        if ws is None:
            return
        self.path_label.setText(f"Workspace: {ws.root}")
        status = ws.get_workflow_status()
        self.step_strip.update_status(status)
        self.step_panel.update_status(status)
        if self.intrinsic_charuco_panel is None:
            self._build_target_panels(ws)
        cams = ws.cameras.load() if ws.cameras.exists() else None
        rows = sorted(cams.cameras.values(), key=lambda c: c.cam_id) if cams else []
        self.cam_table.setRowCount(len(rows))
        for i, c in enumerate(rows):
            fx = f"{c.matrix[0, 0]:.1f}" if c.matrix is not None else "—"
            err = f"{c.error:.3f}" if c.error is not None else "—"
            for j, text in enumerate(
                [str(c.cam_id), f"{c.size[0]}x{c.size[1]}", fx, err, "yes" if c.is_posed else "no"]
            ):
                self.cam_table.setItem(i, j, QTableWidgetItem(text))
