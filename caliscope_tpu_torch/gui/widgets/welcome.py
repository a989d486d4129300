"""Welcome screen: open/create a project + recent-projects list.

Port of caliscope_tpu/gui/widgets/welcome.py.

Parity: reference gui/widgets/welcome_widget.py (open_project_requested /
recent_project_selected signals; newest-first recents whose dirs still
exist, main_widget.py:58-60).
"""

from __future__ import annotations

from pathlib import Path

from caliscope_tpu_torch.gui.qt import (
    QFileDialog,
    QLabel,
    QPushButton,
    QVBoxLayout,
    QWidget,
    Signal,
)


class WelcomeWidget(QWidget):
    open_project_requested = Signal()
    recent_project_selected = Signal(str)

    def __init__(self, recent_projects: list[str], parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        title = QLabel("caliscope-tpu")
        layout.addWidget(title)
        sub = QLabel("Multicamera calibration and motion capture, TPU-native.")
        sub.setWordWrap(True)
        layout.addWidget(sub)

        open_btn = QPushButton("Open / create project…")
        open_btn.clicked.connect(self.open_project_requested.emit)
        layout.addWidget(open_btn)

        layout.addWidget(QLabel("Recent projects:"))
        self.recent_buttons: list[QPushButton] = []
        for path in recent_projects:
            if not Path(path).is_dir():
                continue
            b = QPushButton(path)
            b.clicked.connect(lambda p=path: self.recent_project_selected.emit(p))
            layout.addWidget(b)
            self.recent_buttons.append(b)
        if not self.recent_buttons:
            layout.addWidget(QLabel("(none yet)"))
        layout.addStretch(1)

    def browse(self) -> str:
        return QFileDialog.getExistingDirectory(self, "Open workspace")
