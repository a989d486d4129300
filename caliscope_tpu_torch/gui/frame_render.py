"""Threaded live frame rendering for the cameras tab.

Port of caliscope_tpu/gui/frame_render.py.

Parity: reference src/caliscope/gui/views/intrinsic_calibration_widget.py:341
(FrameRenderThread) — raw tracked frames are converted to display pixmaps
OFF the GUI thread: overlay layers (current detections, accumulated
coverage, selected grids), optional undistortion preview, downscale to a
display edge length, then one image_ready signal per frame (QImage — see
FrameRenderThread docstring for why not QPixmap). The thread
reads a display queue the presenter feeds during extraction; the queue is
bounded and DROPPING (display is best-effort, extraction must never block
on rendering).

Rendering is numpy (gui/rendering.py helpers) rather than QPainter, so the
identical pixels are produced — and assertable — under both Qt backends.
The undistortion preview runs `CameraData.undistort_frame` (grid_sample) on
the thread's device, CUDA unless named. An exception in the render loop is
kept in `error`, emitted on `error_occurred` and re-raised: it ends the
thread, never silently.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field

import numpy as np

from caliscope_tpu_torch.gui.qt import QImage, QPixmap, QThread, Signal
from caliscope_tpu_torch.gui.rendering import draw_points, to_qimage

# overlay colors (RGB)
CURRENT_POINTS_COLOR = np.array([220, 40, 40], np.uint8)
ACCUMULATED_COLOR = np.array([40, 170, 170], np.uint8)
SELECTED_GRIDS_COLOR = np.array([80, 200, 255], np.uint8)


@dataclass
class TrackedFrame:
    """One display item: the raw frame plus overlay point sets."""

    frame: np.ndarray  # (H, W) or (H, W, 3) uint8
    current_xy: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    accumulated_xy: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    selected_xy: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))


@dataclass
class OverlaySettings:
    show_current_points: bool = True
    show_accumulated: bool = True
    show_selected_grids: bool = True


def make_display_queue(maxsize: int = 4) -> "queue.Queue[TrackedFrame | None]":
    q = queue.Queue(maxsize=maxsize)
    q.dropped = 0  # frames offer_frame threw away to keep the producer running
    return q


def offer_frame(q: "queue.Queue[TrackedFrame | None]", item: "TrackedFrame | None") -> None:
    """Non-blocking put that drops the OLDEST entry under pressure — the
    producer (extraction) must never stall on the display path."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
                if hasattr(q, "dropped"):
                    q.dropped += 1
            except queue.Empty:
                pass


class FrameRenderThread(QThread):
    """Consumes TrackedFrames from a display queue and emits display
    images. None in the queue is the stop sentinel (stop() also works).

    The worker emits QIMAGES, not QPixmaps: under real Qt, QPixmap is a
    GUI-thread-only resource ("QPixmap: It is not safe to use pixmaps
    outside the GUI thread"); QImage is thread-safe. Convert at the
    consuming slot — connect_to_label wires that up."""

    image_ready = Signal(QImage)
    error_occurred = Signal(str)

    def __init__(self, display_queue, camera=None, pixmap_edge_length: int = 500, parent=None, device=None):
        super().__init__(parent)
        self._queue = display_queue
        self._camera = camera
        self._edge = pixmap_edge_length
        self._device = device  # the undistortion preview's: CUDA unless named
        self.error: BaseException | None = None
        self.frames_rendered = 0
        self._keep_running = True
        self._undistort = False
        self._overlays = OverlaySettings()
        self._last: TrackedFrame | None = None
        # overlay geometry scales with source resolution (reference sizing)
        width = camera.size[0] if camera is not None and camera.size else 1280
        self._accum_radius = max(1, width // 800)
        self._current_radius = max(2, width // 600)

    # ---- control (GUI thread) ------------------------------------------------
    def stop(self) -> None:
        self._keep_running = False

    def set_undistort(self, enabled: bool, calibrated_camera=None) -> None:
        self._undistort = bool(enabled)
        if calibrated_camera is not None:
            self._camera = calibrated_camera

    def set_overlay_visibility(self, current_points: bool, accumulated: bool, selected_grids: bool) -> None:
        self._overlays.show_current_points = current_points
        self._overlays.show_accumulated = accumulated
        self._overlays.show_selected_grids = selected_grids

    def connect_to_label(self, label) -> None:
        """Wire image_ready to a QLabel: the QImage -> QPixmap conversion
        happens in this GUI-thread slot (QPixmap is not thread-safe)."""
        self.image_ready.connect(lambda img: label.setPixmap(QPixmap.fromImage(img)))

    def rerender_cached(self) -> None:
        """Re-render the last frame with current settings (overlay toggles
        should not wait for the next live frame)."""
        if self._last is not None:
            self.image_ready.emit(self._render(self._last))

    # ---- worker --------------------------------------------------------------
    def run(self) -> None:
        try:
            while self._keep_running:
                try:
                    item = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is None:
                    break
                self._last = item
                self.image_ready.emit(self._render(item))
                self.frames_rendered += 1
        except BaseException as e:
            self.error = e
            self.error_occurred.emit(f"{type(e).__name__}: {e}")
            raise

    def _render(self, tf: TrackedFrame) -> QImage:
        img = tf.frame
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        img = np.ascontiguousarray(img[:, :, :3], np.uint8).copy()
        if self._undistort and self._camera is not None and self._camera.matrix is not None:
            img = self._camera.undistort_frame(img, device=self._device)
        if self._overlays.show_accumulated and len(tf.accumulated_xy):
            draw_points(img, tf.accumulated_xy, ACCUMULATED_COLOR, radius=self._accum_radius)
        if self._overlays.show_selected_grids and len(tf.selected_xy):
            draw_points(img, tf.selected_xy, SELECTED_GRIDS_COLOR, radius=self._current_radius)
        if self._overlays.show_current_points and len(tf.current_xy):
            draw_points(img, tf.current_xy, CURRENT_POINTS_COLOR, radius=self._current_radius)
        h, w = img.shape[:2]
        scale = self._edge / max(h, w)
        if scale < 1.0:
            # integer-stride downscale: cheap, and identical under both backends
            step = max(1, int(round(1.0 / scale)))
            img = img[::step, ::step]
        return to_qimage(img)
