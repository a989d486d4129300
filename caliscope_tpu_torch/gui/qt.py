"""Qt backend selector.

Port of caliscope_tpu/gui/qt.py.

The GUI code is written against the PySide6 API (reference
src/caliscope/gui/main_widget.py and friends are PySide6 throughout). This
module re-exports the names the GUI uses from PySide6 when it is installed;
otherwise it falls back to the pure-Python headless implementation in
gui/headless.py, which reproduces the Qt object model (signals/slots,
queued delivery, widget tree, event loop) without any native dependency.

Why a fallback at all: the GUI must be testable in CI images without
libGL/X11/Qt wheels. With PySide6 present the same code runs unmodified
under QT_QPA_PLATFORM=offscreen (the reference's own test strategy,
reference tests/conftest.py:92); without it, the headless backend
keeps every view, presenter binding, and interaction contract executable.

Set CALISCOPE_TPU_FORCE_HEADLESS_QT=1 to force the fallback (used by tests
so CI covers the code path that exercises them even when PySide6 exists).
"""

from __future__ import annotations

import os

USING_PYSIDE6 = False

if not os.environ.get("CALISCOPE_TPU_FORCE_HEADLESS_QT"):
    try:
        from PySide6.QtCore import (  # noqa: F401
            QObject,
            Qt,
            QThread,
            QTimer,
            Signal,
        )
        from PySide6.QtGui import QAction, QBrush, QColor, QImage, QPixmap  # noqa: F401
        from PySide6.QtWidgets import (  # noqa: F401
            QApplication,
            QCheckBox,
            QComboBox,
            QDialog,
            QDoubleSpinBox,
            QFileDialog,
            QFormLayout,
            QGridLayout,
            QGroupBox,
            QHBoxLayout,
            QLabel,
            QLineEdit,
            QListWidget,
            QListWidgetItem,
            QMainWindow,
            QMenu,
            QMessageBox,
            QPlainTextEdit,
            QProgressBar,
            QPushButton,
            QScrollArea,
            QSlider,
            QSpinBox,
            QSplitter,
            QTableWidget,
            QTableWidgetItem,
            QTabWidget,
            QVBoxLayout,
            QWidget,
        )

        USING_PYSIDE6 = True
    except ImportError:
        pass

if not USING_PYSIDE6:
    from caliscope_tpu_torch.gui.headless import (  # noqa: F401
        QAction,
        QApplication,
        QBrush,
        QCheckBox,
        QColor,
        QComboBox,
        QDialog,
        QDoubleSpinBox,
        QFileDialog,
        QFormLayout,
        QGridLayout,
        QGroupBox,
        QHBoxLayout,
        QImage,
        QLabel,
        QLineEdit,
        QListWidget,
        QListWidgetItem,
        QMainWindow,
        QMenu,
        QMessageBox,
        QObject,
        QPixmap,
        QPlainTextEdit,
        QProgressBar,
        QPushButton,
        QScrollArea,
        QSlider,
        QSpinBox,
        QSplitter,
        Qt,
        QTableWidget,
        QTableWidgetItem,
        QTabWidget,
        QThread,
        QTimer,
        QVBoxLayout,
        QWidget,
        Signal,
    )
