"""Calibration-target configuration panels with live board preview.

Port of caliscope_tpu/gui/widgets/config_panels.py.

Parity: reference gui/widgets/charuco_config_panel.py,
chessboard_config_panel.py, aruco_marker_set_panel.py — edit the target
definition, preview the rendered board, persist through the workspace's
TargetsRepository. The preview uses the first-party numpy board renderer
(targets/charuco.py board_image), so what you see is exactly what the
synthetic engine and the printable export produce.
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.qt import (
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QGridLayout,
    QGroupBox,
    QLabel,
    QPushButton,
    QSpinBox,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
    Signal,
)
from caliscope_tpu_torch.gui.rendering import to_pixmap
from caliscope_tpu_torch.targets import ArucoMarker, ArucoMarkerSet, Charuco, Chessboard
from caliscope_tpu_torch.targets.charuco import ARUCO_DICTIONARY_CAPACITY


class CharucoConfigPanel(QWidget):
    """Edit a ChArUco board definition; emits target_changed(Charuco)."""

    target_changed = Signal(object)

    def __init__(self, charuco: Charuco, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        grid_box = QGroupBox("ChArUco board")
        grid = QGridLayout(grid_box)

        self.rows = QSpinBox()
        self.rows.setRange(2, 30)
        self.rows.setValue(charuco.rows)
        self.columns = QSpinBox()
        self.columns.setRange(2, 30)
        self.columns.setValue(charuco.columns)
        self.square_mm = QDoubleSpinBox()
        self.square_mm.setRange(1.0, 1000.0)
        self.square_mm.setValue(charuco.square_size_m * 1000.0)
        self.square_mm.setSuffix(" mm")
        self.aruco_scale = QDoubleSpinBox()
        self.aruco_scale.setRange(0.3, 0.95)
        self.aruco_scale.setSingleStep(0.05)
        self.aruco_scale.setValue(charuco.aruco_scale)
        self.dictionary = QComboBox()
        for name in sorted(ARUCO_DICTIONARY_CAPACITY):
            self.dictionary.addItem(name)
        self.dictionary.setCurrentText(charuco.dictionary)
        self.inverted = QCheckBox("Inverted (white markers on black)")
        self.inverted.setChecked(charuco.inverted)
        self.thickness_mm = QDoubleSpinBox()
        self.thickness_mm.setRange(0.0, 100.0)
        self.thickness_mm.setValue(charuco.thickness_m * 1000.0)
        self.thickness_mm.setSuffix(" mm")

        for r, (label, w) in enumerate(
            [
                ("Rows (squares)", self.rows),
                ("Columns (squares)", self.columns),
                ("Square size", self.square_mm),
                ("Marker/square ratio", self.aruco_scale),
                ("Dictionary", self.dictionary),
                ("Substrate thickness", self.thickness_mm),
            ]
        ):
            grid.addWidget(QLabel(label), r, 0)
            grid.addWidget(w, r, 1)
        grid.addWidget(self.inverted, 6, 0)
        layout.addWidget(grid_box)

        self.preview = QLabel()
        layout.addWidget(self.preview)
        self.error_label = QLabel("")
        layout.addWidget(self.error_label)
        self.apply_btn = QPushButton("Apply")
        self.apply_btn.clicked.connect(self._apply)
        layout.addWidget(self.apply_btn)
        self.save_btn = QPushButton("Save printable PNG…")
        self.save_btn.clicked.connect(self._save_png)
        layout.addWidget(self.save_btn)
        layout.addStretch(1)
        self._charuco = charuco
        self._render_preview(charuco)

    @property
    def charuco(self) -> Charuco:
        return self._charuco

    def _build(self) -> Charuco:
        return Charuco(
            rows=self.rows.value(),
            columns=self.columns.value(),
            square_size_m=self.square_mm.value() / 1000.0,
            aruco_scale=self.aruco_scale.value(),
            dictionary=self.dictionary.currentText(),
            inverted=self.inverted.isChecked(),
            thickness_m=self.thickness_mm.value() / 1000.0,
        )

    def _render_preview(self, ch: Charuco) -> None:
        import numpy as np

        gray = ch.board_image(px_per_square=24, margin_squares=0.25)
        self.preview.setPixmap(to_pixmap(np.repeat(gray[:, :, None], 3, axis=2)))

    def _apply(self) -> None:
        try:
            ch = self._build()
            # dictionary-pool validation (reference project_setup_view.py::
            # _render_charuco_or_warn): a grid needing more markers than the
            # family's largest dictionary holds cannot be rendered
            from caliscope_tpu_torch.targets.charuco import fit_dictionary_pool

            fit_dictionary_pool(ch.dictionary, ch.n_markers)
            self._render_preview(ch)
        except Exception as e:
            self.error_label.setText(str(e))
            self._revert_overflow()
            return
        self.error_label.setText("")
        self._charuco = ch
        self.target_changed.emit(ch)

    def _revert_overflow(self) -> None:
        """Reset the editable fields to the last VALID board (reference
        _revert_charuco_overflow): the warning stays visible, but the panel
        never persists or previews an unconstructible configuration."""
        ch = self._charuco
        self.rows.setValue(ch.rows)
        self.columns.setValue(ch.columns)
        self.dictionary.setCurrentText(ch.dictionary)
        self.aruco_scale.setValue(ch.aruco_scale)

    def _save_png(self) -> None:
        from caliscope_tpu_torch.gui.qt import QFileDialog

        path, _f = QFileDialog.getSaveFileName(self, "Save ChArUco board", "charuco_board.png", "PNG Files (*.png)")
        if path:
            self._charuco.save_image(path)
            self.error_label.setText(f"Saved {path}")


class ChessboardConfigPanel(QWidget):
    target_changed = Signal(object)

    def __init__(self, chessboard: Chessboard, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        box = QGroupBox("Chessboard (internal corners)")
        grid = QGridLayout(box)
        self.rows = QSpinBox()
        self.rows.setRange(2, 30)
        self.rows.setValue(chessboard.rows)
        self.columns = QSpinBox()
        self.columns.setRange(2, 30)
        self.columns.setValue(chessboard.columns)
        self.square_mm = QDoubleSpinBox()
        self.square_mm.setRange(0.0, 1000.0)
        self.square_mm.setValue((chessboard.square_size_m or 0.0) * 1000.0)
        self.square_mm.setSuffix(" mm")
        for r, (label, w) in enumerate(
            [("Corner rows", self.rows), ("Corner columns", self.columns), ("Square size", self.square_mm)]
        ):
            grid.addWidget(QLabel(label), r, 0)
            grid.addWidget(w, r, 1)
        layout.addWidget(box)
        self.error_label = QLabel("")
        layout.addWidget(self.error_label)
        self.apply_btn = QPushButton("Apply")
        self.apply_btn.clicked.connect(self._apply)
        layout.addWidget(self.apply_btn)
        layout.addStretch(1)
        self._chessboard = chessboard

    @property
    def chessboard(self) -> Chessboard:
        return self._chessboard

    def _apply(self) -> None:
        try:
            cb = Chessboard(
                rows=self.rows.value(),
                columns=self.columns.value(),
                square_size_m=(self.square_mm.value() / 1000.0) or None,
            )
        except Exception as e:
            self.error_label.setText(str(e))
            return
        self.error_label.setText("")
        self._chessboard = cb
        self.target_changed.emit(cb)


class ArucoSetPanel(QWidget):
    """View/edit the standalone ArUco marker set (ids, sizes, static flags)."""

    target_changed = Signal(object)

    def __init__(self, marker_set: ArucoMarkerSet | None, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        layout.addWidget(QLabel("ArUco markers (id, edge mm, static)"))
        self.table = QTableWidget(0, 3)
        self.table.setHorizontalHeaderLabels(["id", "size (mm)", "static"])
        layout.addWidget(self.table)
        self.error_label = QLabel("")
        layout.addWidget(self.error_label)
        self.apply_btn = QPushButton("Apply")
        self.apply_btn.clicked.connect(self._apply)
        layout.addWidget(self.apply_btn)
        layout.addStretch(1)
        self._marker_set = marker_set
        if marker_set is not None:
            self.load(marker_set)

    @property
    def marker_set(self) -> ArucoMarkerSet | None:
        return self._marker_set

    def load(self, ms: ArucoMarkerSet) -> None:
        self._marker_set = ms
        markers = sorted(ms.markers.values(), key=lambda m: m.marker_id)
        self.table.setRowCount(len(markers))
        for i, m in enumerate(markers):
            self.table.setItem(i, 0, QTableWidgetItem(str(m.marker_id)))
            self.table.setItem(i, 1, QTableWidgetItem(f"{m.size_m * 1000:.1f}"))
            self.table.setItem(i, 2, QTableWidgetItem("yes" if m.static else "no"))

    def _apply(self) -> None:
        if self._marker_set is None:
            return
        try:
            markers = {}
            for i in range(self.table.rowCount()):
                mid = int(self.table.item(i, 0).text())
                size = float(self.table.item(i, 1).text()) / 1000.0
                static = self.table.item(i, 2).text().strip().lower() in ("yes", "true", "1")
                markers[mid] = ArucoMarker(mid, size, static)
            ms = ArucoMarkerSet(
                self._marker_set.dictionary, markers,
                self._marker_set.links, self._marker_set.mirror_pairs,
            )
        except Exception as e:
            self.error_label.setText(str(e))
            return
        self.error_label.setText("")
        self._marker_set = ms
        self.target_changed.emit(ms)
