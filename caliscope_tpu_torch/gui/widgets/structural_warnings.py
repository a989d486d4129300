"""Multicamera coverage structural warnings panel.

Port of caliscope_tpu/gui/widgets/structural_warnings.py.

Parity: reference gui/widgets/structural_warnings.py — surfaces
disconnected camera groups, weak links, and leaf cameras detected by
coverage analysis before the user burns minutes on a doomed calibration.
"""

from __future__ import annotations

from caliscope_tpu_torch.coverage import WarningSeverity, analyze_multi_camera_coverage, detect_structural_warnings
from caliscope_tpu_torch.gui.qt import QLabel, QVBoxLayout, QWidget
from caliscope_tpu_torch.observations import ImagePoints

_BADGE = {
    WarningSeverity.CRITICAL: "✖",
    WarningSeverity.WARNING: "⚠",
    WarningSeverity.INFO: "ℹ",
}


class StructuralWarningsWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._layout = QVBoxLayout(self)
        self.header = QLabel("Coverage:")
        self._layout.addWidget(self.header)
        self.rows: list[QLabel] = []
        self.warnings = []

    def update_from_points(self, points: ImagePoints) -> None:
        report = analyze_multi_camera_coverage(points)
        self.warnings = detect_structural_warnings(report, report.n_cameras)
        for row in self.rows:
            self._layout.removeWidget(row)
        self.rows = []
        if not self.warnings:
            self.header.setText("Coverage: no structural issues detected.")
            return
        self.header.setText(f"Coverage: {len(self.warnings)} issue(s).")
        for w in self.warnings:
            label = QLabel(f"{_BADGE.get(w.severity, '•')} {w.message}")
            label.setWordWrap(True)
            self._layout.addWidget(label)
            self.rows.append(label)

    @property
    def has_critical(self) -> bool:
        return any(w.severity is WarningSeverity.CRITICAL for w in self.warnings)
