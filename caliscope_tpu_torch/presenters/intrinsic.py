"""Intrinsic-calibration presenter (per-camera workflow state machine).

Port of caliscope_tpu/presenters/intrinsic.py (reference
src/caliscope/gui/presenters/intrinsic_calibration_presenter.py:52):
extract-then-calibrate per camera in a task thread, exposing quality report
and state for the Intrinsics tab. The tracker runs on its own device, the
solve on the presenter's (CUDA unless device="cpu"). Given a display queue
(gui.frame_render), the run tees every tracked frame into it; frames and
points reach the queue as host numpy arrays, whatever device tracked them.
"""

from __future__ import annotations

import logging
from enum import Enum, auto
from pathlib import Path
from typing import Optional

from caliscope_tpu_torch.cameras import CameraData
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.pipelines.calibrate_intrinsics import IntrinsicCalibrationOutput
from caliscope_tpu_torch.presenters.signal import Signal
from caliscope_tpu_torch.tasks import TaskManager
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)


class IntrinsicCalibrationState(Enum):
    NO_VIDEO = auto()
    READY = auto()
    EXTRACTING = auto()
    CALIBRATING = auto()
    CALIBRATED = auto()
    FAILED = auto()


def _host(a):
    """A host numpy view of a frame or point array: a tensor (on any
    device) is copied over explicitly, never handed to np.asarray."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _DisplayTeeTracker(Tracker):
    """Wraps a tracker and tees every (frame, detections) pair into a
    display queue as gui.frame_render.TrackedFrame items. Accumulates all
    detections so the coverage overlay grows as extraction proceeds. Pure
    pass-through for detection semantics."""

    def __init__(self, inner: Tracker, display_queue):
        import numpy as np

        self.inner = inner
        self.queue = display_queue
        # amortized-growth accumulation buffer: re-concatenating the whole
        # history per frame was O(n^2) over an extraction, ON the
        # extraction path. Views of buf[:count] handed to the render
        # thread stay valid: appends only write past count, and growth
        # reallocates (the reader's old array is untouched).
        self._accum_buf = np.zeros((256, 2))
        self._accum_count = 0

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def pixel_format(self):
        return self.inner.pixel_format

    def _detect(self, frame, cam_id: int = 0, rotation_count: int = 0):
        pkt = self.inner._detect(frame, cam_id, rotation_count)
        self._offer(frame, pkt)
        return pkt

    def get_points_batch(self, frames, cam_id: int = 0, rotation_count: int = 0):
        pkts = self.inner.get_points_batch(frames, cam_id, rotation_count)
        for frame, pkt in zip(frames, pkts):
            self._offer(frame, pkt)
        return pkts

    def _offer(self, frame, pkt) -> None:
        import numpy as np

        from caliscope_tpu_torch.gui.frame_render import TrackedFrame, offer_frame

        current = _host(pkt.img_loc).reshape(-1, 2) if len(pkt) else np.zeros((0, 2))
        n = len(current)
        if n:
            if self._accum_count + n > len(self._accum_buf):
                grown = np.zeros((2 * (self._accum_count + n), 2))
                grown[: self._accum_count] = self._accum_buf[: self._accum_count]
                self._accum_buf = grown
            self._accum_buf[self._accum_count : self._accum_count + n] = current
            self._accum_count += n
        offer_frame(
            self.queue,
            TrackedFrame(_host(frame), current, self._accum_buf[: self._accum_count]),
        )

    def get_point_name(self, keypoint_id: int) -> str:
        return self.inner.get_point_name(keypoint_id)

    def get_connected_points(self):
        return self.inner.get_connected_points()

    def cleanup(self) -> None:
        self.inner.cleanup()


class IntrinsicCalibrationPresenter:
    def __init__(
        self,
        camera: CameraData,
        video_path: Optional[Path],
        tracker: Tracker,
        task_manager: Optional[TaskManager] = None,
        frame_step: int = 5,
        display_queue=None,
        device=None,
    ):
        """display_queue: optional gui.frame_render display queue; when set,
        every tracked frame is teed into it during extraction (dropping
        under pressure) so a FrameRenderThread can show live progress —
        the reference feeds its intrinsic widget the same way
        (gui/views/intrinsic_calibration_widget.py:341)."""
        self.camera = camera
        self.video_path = Path(video_path) if video_path else None
        self.tracker = tracker
        self.frame_step = frame_step
        self.display_queue = display_queue
        self.device = device
        self._tasks = task_manager or TaskManager(max_workers=1)
        self._busy: Optional[str] = None
        self._error: Optional[str] = None
        self._points: Optional[ImagePoints] = None
        self._output: Optional[IntrinsicCalibrationOutput] = None

        self.state_changed = Signal("state_changed")
        self.progress_updated = Signal("progress_updated")
        self.calibration_completed = Signal("calibration_completed")
        self.error_occurred = Signal("error_occurred")

    @property
    def state(self) -> IntrinsicCalibrationState:
        if self._busy == "extract":
            return IntrinsicCalibrationState.EXTRACTING
        if self._busy == "calibrate":
            return IntrinsicCalibrationState.CALIBRATING
        if self._error is not None:
            return IntrinsicCalibrationState.FAILED
        if self._output is not None:
            return IntrinsicCalibrationState.CALIBRATED
        if self.video_path is not None and self.video_path.exists():
            return IntrinsicCalibrationState.READY
        return IntrinsicCalibrationState.NO_VIDEO

    @property
    def output(self) -> Optional[IntrinsicCalibrationOutput]:
        return self._output

    def run(self, block: bool = False):
        """Extract + calibrate in one task."""
        if self._busy is not None or self.state is IntrinsicCalibrationState.NO_VIDEO:
            return None
        self._busy = "extract"
        self._error = None
        self.state_changed.emit(self.state)

        def work():
            from caliscope_tpu_torch.api import calibrate_intrinsics, extract_image_points

            tracker = self.tracker
            if self.display_queue is not None:
                tracker = _DisplayTeeTracker(tracker, self.display_queue)
            points = extract_image_points(
                self.video_path, self.camera.cam_id, tracker,
                frame_step=self.frame_step, progress=None,
            )
            if self.display_queue is not None:
                from caliscope_tpu_torch.gui.frame_render import offer_frame

                offer_frame(self.display_queue, None)  # stop sentinel
            self._points = points
            self._busy = "calibrate"
            self.state_changed.emit(self.state)
            return calibrate_intrinsics(points, self.camera, device=self.device)

        def on_done(fut):
            self._busy = None
            try:
                self._output = fut.result()
                self.calibration_completed.emit(self._output)
            except Exception as e:
                self._error = str(e)
                self.error_occurred.emit(str(e))
            self.state_changed.emit(self.state)

        handle = self._tasks.submit(work, name=f"intrinsics_cam_{self.camera.cam_id}")
        handle.future.add_done_callback(on_done)
        if block:
            handle.future.exception()
        return handle
