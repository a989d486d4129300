"""Hyperlink-styled label with a click signal.

Port of caliscope_tpu/gui/widgets/link_label.py.

Parity: reference src/caliscope/gui/widgets/link_label.py:1 — a QLabel
styled and behaving like a hyperlink (accent color, hover underline,
clicked signal on press). Hover/press events only fire under real Qt; the
headless backend exercises the programmatic surface (set_hovered, click).
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.qt import QLabel, Signal
from caliscope_tpu_torch.gui.theme import Colors


class LinkLabel(QLabel):
    clicked = Signal()

    def __init__(self, text: str = "", font_size_px: int = 10, parent=None):
        super().__init__(text, parent)
        self._base_style = f"color: {Colors.PRIMARY}; font-size: {font_size_px}px;"
        self._apply(hovered=False)

    def _apply(self, hovered: bool) -> None:
        deco = "text-decoration: underline;" if hovered else "text-decoration: none;"
        self.setStyleSheet(self._base_style + " " + deco)

    def set_hovered(self, hovered: bool) -> None:
        self._apply(hovered)

    def click(self) -> None:
        self.clicked.emit()

    # real-Qt event hooks (never called headlessly)
    def enterEvent(self, event) -> None:  # pragma: no cover - needs real Qt
        self._apply(hovered=True)
        super().enterEvent(event)

    def leaveEvent(self, event) -> None:  # pragma: no cover - needs real Qt
        self._apply(hovered=False)
        super().leaveEvent(event)

    def mousePressEvent(self, event) -> None:  # pragma: no cover - needs real Qt
        self.clicked.emit()
        super().mousePressEvent(event)
