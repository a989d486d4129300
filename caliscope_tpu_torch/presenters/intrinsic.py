"""Intrinsic-calibration presenter (per-camera workflow state machine).

Port of caliscope_tpu/presenters/intrinsic.py (reference
src/caliscope/gui/presenters/intrinsic_calibration_presenter.py:52):
extract-then-calibrate per camera in a task thread, exposing quality report
and state for the Intrinsics tab. The tracker runs on its own device, the
solve on the presenter's (CUDA unless device="cpu"). The JAX package can tee
every tracked frame into a display queue of its GUI (gui.frame_render);
the port has no GUI yet, so a presenter given a display queue fails its run
with NotImplementedError (ROADMAP.md item 26).
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
        """display_queue: the GUI's display queue of tracked frames
        (reference gui/views/intrinsic_calibration_widget.py:341); not
        ported (item 26)."""
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

            if self.display_queue is not None:
                from caliscope_tpu_torch.solvers.bundle import not_ported

                raise not_ported("The live display of tracked frames (gui.frame_render)", "item 26, the GUI")
            points = extract_image_points(
                self.video_path, self.camera.cam_id, self.tracker,
                frame_step=self.frame_step, progress=None,
            )
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
