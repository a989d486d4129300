"""Centralized visual theme: semantic colors, typography, composed styles.

Port of caliscope_tpu/gui/theme.py.

Parity: reference src/caliscope/gui/theme.py:1 (Colors / Typography /
Styles). Pure string constants, so the module is backend-neutral: under
PySide6 the stylesheets apply as real QSS; under the headless shim
setStyleSheet records them (views can still assert a widget was styled
with e.g. Styles.PRIMARY_BUTTON).

The palette is our own dark scheme (shared with gui/rendering.py's
software rasterizer so pixel renders and chrome agree), with the same
semantic roles the reference exposes: one interactive accent, three
status colors that are never used without an accompanying glyph
(accessibility: never color-alone), four surface levels, a text
hierarchy, and two border weights.
"""

from __future__ import annotations


class Colors:
    """Semantic palette for the dark theme."""

    # interactive accent
    PRIMARY = "#3d7bbf"
    PRIMARY_HOVER = "#4a8ed6"
    PRIMARY_PRESSED = "#2f639c"

    # status (always paired with a glyph, never color-alone)
    SUCCESS = "#5bb974"  # complete / calibrated
    WARNING = "#e0a83c"  # in progress / partial
    ERROR = "#d9574e"  # failed / needs attention

    # surfaces, darkest -> lightest (match rendering.BG = #12141a)
    SURFACE_DARK = "#12141a"  # video / render canvases
    SURFACE = "#23252c"  # default panels
    SURFACE_LIGHT = "#32343c"  # raised elements

    # text hierarchy
    TEXT_PRIMARY = "#f2f3f5"
    TEXT_SECONDARY = "#c4c7cc"
    TEXT_MUTED = "#8b8f96"
    TEXT_DISABLED = "#54565c"

    # borders
    BORDER_SUBTLE = "#32343c"
    BORDER = "#54565c"


class Typography:
    """Composed label styles for recurring patterns."""

    SECTION_HEADER = f"color: {Colors.TEXT_MUTED}; font-size: 11px; font-weight: 600;"  # (Qt QSS has no letter-spacing)
    HELPER_TEXT = f"font-style: italic; color: {Colors.TEXT_MUTED};"
    STATUS_OK = f"color: {Colors.SUCCESS};"
    STATUS_ERROR = f"color: {Colors.ERROR};"


class Styles:
    """Composed QSS for widgets, covering hover/pressed/disabled states."""

    PRIMARY_BUTTON = f"""
        QPushButton {{
            background-color: {Colors.PRIMARY};
            color: {Colors.TEXT_PRIMARY};
            border: none;
            border-radius: 4px;
            padding: 8px 20px;
            font-weight: bold;
        }}
        QPushButton:hover {{ background-color: {Colors.PRIMARY_HOVER}; }}
        QPushButton:pressed {{ background-color: {Colors.PRIMARY_PRESSED}; }}
        QPushButton:disabled {{
            background-color: {Colors.TEXT_DISABLED};
            color: {Colors.TEXT_MUTED};
        }}
    """

    GHOST_BUTTON = f"""
        QPushButton {{
            background-color: transparent;
            color: {Colors.PRIMARY};
            border: 1px solid {Colors.PRIMARY};
            border-radius: 4px;
            padding: 4px 12px;
        }}
        QPushButton:hover {{ background-color: rgba(61, 123, 191, 0.15); }}
        QPushButton:pressed {{ background-color: rgba(61, 123, 191, 0.25); }}
        QPushButton:disabled {{
            color: {Colors.TEXT_DISABLED};
            border-color: {Colors.BORDER_SUBTLE};
        }}
    """

    LIST_SIDEBAR = f"""
        QListWidget::item {{
            padding: 8px 12px;
            min-height: 24px;
        }}
        QListWidget::item:selected {{
            background-color: {Colors.PRIMARY_PRESSED};
        }}
    """

    PANEL = (
        f"background-color: {Colors.SURFACE}; "
        f"border: 1px solid {Colors.BORDER}; border-radius: 4px;"
    )
