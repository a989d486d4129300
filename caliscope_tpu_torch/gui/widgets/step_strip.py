"""Workflow step strip: the intrinsics -> extract -> extrinsics progress rail.

Port of caliscope_tpu/gui/widgets/step_strip.py.

Parity: reference gui/widgets/calibration_step_strip.py — one badge per
workflow stage, fed from WorkflowStatus (workspace.py StepStatus).
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.qt import QHBoxLayout, QLabel, QWidget
from caliscope_tpu_torch.workspace import StepStatus, WorkflowStatus

_GLYPH = {
    StepStatus.NOT_STARTED: "○",
    StepStatus.AVAILABLE: "○",
    StepStatus.INCOMPLETE: "◐",
    StepStatus.COMPLETE: "●",
}


class CalibrationStepStrip(QWidget):
    STEPS = ("Intrinsics", "Extract", "Extrinsics")

    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QHBoxLayout(self)
        self.badges: dict[str, QLabel] = {}
        for i, name in enumerate(self.STEPS):
            badge = QLabel(f"○ {name}")
            layout.addWidget(badge)
            self.badges[name] = badge
            if i < len(self.STEPS) - 1:
                layout.addWidget(QLabel("→"))
        layout.addStretch(1)

    def update_status(self, status: WorkflowStatus) -> None:
        states = {
            "Intrinsics": status.intrinsic_step_status,
            "Extract": status.extrinsic_2d_step_status,
            "Extrinsics": status.extrinsic_calibration_step_status,
        }
        for name, st in states.items():
            self.badges[name].setText(f"{_GLYPH.get(st, '○')} {name}")

    def step_state(self, name: str) -> str:
        return self.badges[name].text().split(" ")[0]


class WorkflowStepRow(QWidget):
    """One workflow stage with a status glyph AND a detail line
    (reference project_setup_view.py::WorkflowStepRow:63-156): the strip
    shows WHERE you are, the rows say WHAT is missing."""

    def __init__(self, name: str, parent=None):
        super().__init__(parent)
        layout = QHBoxLayout(self)
        self.badge = QLabel("○")
        layout.addWidget(self.badge)
        self.name_label = QLabel(name)
        layout.addWidget(self.name_label)
        self.detail = QLabel("")
        self.detail.setWordWrap(True)
        layout.addWidget(self.detail)
        layout.addStretch(1)

    def set_status(self, status: StepStatus, detail_text: str) -> None:
        self.badge.setText(_GLYPH.get(status, "○"))
        self.detail.setText(detail_text)


class WorkflowStepPanel(QWidget):
    """The four per-stage rows with derived detail text (reference
    project_setup_view.py::_update_{intrinsic,extraction,extrinsic,
    reconstruction}_row:795-887)."""

    STEPS = ("Intrinsics", "Extraction", "Extrinsics", "Reconstruction")

    def __init__(self, parent=None):
        super().__init__(parent)
        from caliscope_tpu_torch.gui.qt import QVBoxLayout

        layout = QVBoxLayout(self)
        self.rows: dict[str, WorkflowStepRow] = {}
        for name in self.STEPS:
            row = WorkflowStepRow(name)
            layout.addWidget(row)
            self.rows[name] = row

    def update_status(self, status: WorkflowStatus) -> None:
        n = status.camera_count
        if not status.intrinsic_videos_available:
            intr = f"waiting for intrinsic videos (missing cams {status.intrinsic_videos_missing})" if n else "add intrinsic videos (calibration/intrinsic/cam_N.mp4)"
        elif status.cameras_needing_calibration:
            intr = f"{n} camera(s); needs calibration: {status.cameras_needing_calibration}"
        else:
            intr = f"all {n} camera(s) calibrated"
        self.rows["Intrinsics"].set_status(status.intrinsic_step_status, intr)

        if not status.extrinsic_videos_available:
            ext = f"waiting for extrinsic videos (missing cams {status.extrinsic_videos_missing})" if n else "add extrinsic videos (calibration/extrinsic/cam_N.mp4)"
        elif not status.extrinsic_2d_extraction_complete:
            ext = "videos present; 2D extraction not run"
        else:
            ext = "2D points extracted"
        self.rows["Extraction"].set_status(status.extrinsic_2d_step_status, ext)

        if status.extrinsic_calibration_complete:
            cal = "capture volume solved"
        elif status.extrinsic_2d_extraction_complete:
            cal = "ready: run extrinsic calibration"
        else:
            cal = "needs 2D extraction first"
        self.rows["Extrinsics"].set_status(status.extrinsic_calibration_step_status, cal)

        if status.recordings_available:
            rec_status = (
                StepStatus.AVAILABLE if status.extrinsic_calibration_complete else StepStatus.NOT_STARTED
            )
            rec = f"{len(status.recording_names)} recording(s): {', '.join(status.recording_names[:4])}"
            if not status.extrinsic_calibration_complete:
                rec += " (calibrate extrinsics first)"
        else:
            rec_status = StepStatus.NOT_STARTED
            rec = "add recordings (recordings/<name>/cam_N.mp4)"
        self.rows["Reconstruction"].set_status(rec_status, rec)

    def detail_text(self, name: str) -> str:
        return self.rows[name].detail.text()
