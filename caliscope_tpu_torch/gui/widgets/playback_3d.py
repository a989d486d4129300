"""3D capture-volume playback: world points + camera frusta + frame scrub.

Port of caliscope_tpu/gui/widgets/playback_3d.py.

Parity: reference gui/widgets/qt3d_playback_widget.py + gui/qt3d/ — orbit
view of the calibrated volume with per-sync-index playback. Rendering is
the software rasterizer in gui/rendering.py (no Qt3D/GPU dependency); the
orbit/zoom controls mutate the virtual camera and re-render.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.qt import (
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSlider,
    Qt,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.rendering import Scene3DRenderer, to_pixmap
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX


class Playback3DWidget(QWidget):
    def __init__(self, parent=None, width: int = 640, height: int = 480):
        super().__init__(parent)
        self.renderer = Scene3DRenderer(width, height)
        self._volume = None
        self._view_model = None
        self._sync_indices: np.ndarray = np.zeros(0, int)

        layout = QVBoxLayout(self)
        self.canvas = QLabel()
        layout.addWidget(self.canvas)

        controls = QHBoxLayout()
        for label, fn in [
            ("⟲", lambda: self._orbit(-15, 0)),
            ("⟳", lambda: self._orbit(15, 0)),
            ("↑", lambda: self._orbit(0, 10)),
            ("↓", lambda: self._orbit(0, -10)),
            ("+", lambda: self._zoom(0.8)),
            ("−", lambda: self._zoom(1.25)),
        ]:
            b = QPushButton(label)
            b.clicked.connect(fn)
            controls.addWidget(b)
        self.frame_label = QLabel("")
        controls.addWidget(self.frame_label)
        layout.addLayout(controls)

        self.slider = QSlider(Qt.Horizontal)
        self.slider.valueChanged.connect(lambda _v: self.refresh())
        layout.addWidget(self.slider)

        # per-frame scale-error strip beside the slider (reference embeds
        # distance_sparkline.py next to the playback slider); hover-seeking
        # on the sparkline drives the slider and vice versa
        from caliscope_tpu_torch.gui.widgets.distance_sparkline import DistanceSparkline

        self.sparkline = DistanceSparkline()
        self.sparkline.cursor_moved.connect(self.slider.setValue)
        layout.addWidget(self.sparkline)

    def set_scale_report(self, report) -> None:
        """Attach a VolumetricScaleReport to the playback sparkline."""
        self.sparkline.set_data(report, self._sync_indices)
        self.sparkline.set_cursor(self.slider.value())

    # ---- data ---------------------------------------------------------------
    def set_view_model(self, vm) -> None:
        """Drive playback from a PlaybackViewModel (canonical fixed-size
        buffers + wireframe topology; reference
        gui/view_models/playback_view_model.py). Preferred over set_volume
        for reconstructed recordings."""
        self._view_model = vm
        self._volume = None
        self._sync_indices = vm.valid_sync_indices
        self.slider.setRange(0, max(len(self._sync_indices) - 1, 0))
        centers = vm.get_camera_positions()
        # a static-only view model has points but no dynamic sync indices,
        # so current_sync_index() can be None even when has_points is True
        sync0 = self.current_sync_index()
        first = vm.get_frame_geometry(sync0 if sync0 is not None else 0) if vm.has_points else None
        pts = first.points[np.isfinite(first.points).all(axis=1)] if first is not None else np.zeros((0, 3))
        anchor = pts if len(pts) else (centers if centers is not None else np.zeros((1, 3)))
        self.renderer.target = anchor.mean(axis=0)
        self.renderer.distance = float(np.linalg.norm(anchor.std(axis=0))) * 4 + 1.0
        self.refresh()

    def set_volume(self, volume) -> None:
        self._view_model = None
        self._volume = volume
        wp = volume.world_points
        syncs = np.unique(wp.sync_index[wp.sync_index != STATIC_SYNC_INDEX]).astype(int)
        self._sync_indices = syncs
        self.slider.setRange(0, max(len(syncs) - 1, 0))
        # frame the scene: target = centroid, distance from extent
        xyz = np.asarray(wp.xyz)
        if len(xyz):
            self.renderer.target = xyz.mean(axis=0)
            extent = float(np.linalg.norm(xyz.std(axis=0))) * 4 + 1.0
            self.renderer.distance = extent
        self.refresh()

    def current_sync_index(self) -> int | None:
        if not len(self._sync_indices):
            return None
        return int(self._sync_indices[min(self.slider.value(), len(self._sync_indices) - 1)])

    # ---- view controls --------------------------------------------------------
    def _orbit(self, d_az: float, d_el: float) -> None:
        self.renderer.azimuth = (self.renderer.azimuth + d_az) % 360
        self.renderer.elevation = float(np.clip(self.renderer.elevation + d_el, -85, 85))
        self.refresh()

    def _zoom(self, factor: float) -> None:
        self.renderer.distance = float(np.clip(self.renderer.distance * factor, 0.2, 100.0))
        self.refresh()

    # ---- render ---------------------------------------------------------------
    def refresh(self) -> None:
        if hasattr(self, "sparkline"):
            self.sparkline.set_cursor(self.slider.value())
        if self._view_model is not None:
            vm = self._view_model
            sync = self.current_sync_index()
            # sync None + points present = static-only recording: frame 0
            # composites the static points (dynamic slots are NaN anyway)
            if sync is None and vm.has_points:
                geo = vm.get_frame_geometry(0)
            else:
                geo = vm.get_frame_geometry(sync) if sync is not None else None
            lines, colors = vm.get_static_wireframe_data()
            wire = geo.points[lines] if geo is not None and len(lines) else None
            img = self.renderer.render(
                geo.points if geo is not None else None,
                vm.camera_array,
                wire_lines=wire,
                wire_colors=colors if wire is not None else None,
            )
            self.canvas.setPixmap(to_pixmap(img))
            self.frame_label.setText(f"sync {sync}" if sync is not None else "")
            return
        if self._volume is None:
            return
        wp = self._volume.world_points
        xyz = np.asarray(wp.xyz)
        sync = self.current_sync_index()
        highlight = xyz[wp.sync_index == sync] if sync is not None else None
        img = self.renderer.render(xyz, self._volume.camera_array, highlight)
        self.canvas.setPixmap(to_pixmap(img))
        self.frame_label.setText(f"sync {sync}" if sync is not None else "")
