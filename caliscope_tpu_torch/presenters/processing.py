"""Multicamera processing + reconstruction presenters.

Port of caliscope_tpu/presenters/processing.py.

Parity: reference src/caliscope/gui/presenters/
(MultiCameraProcessingPresenter, ReconstructionPresenter) — run the streaming
extraction / reconstruction pipelines in task threads with live frame
callbacks surfaced as signals.
"""

from __future__ import annotations

import logging
from enum import Enum, auto
from pathlib import Path
from typing import Optional

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.media import SynchronizedTimestamps
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.presenters.signal import Signal
from caliscope_tpu_torch.tasks import TaskManager
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)


class ProcessingState(Enum):
    IDLE = auto()
    PROCESSING = auto()
    COMPLETE = auto()
    FAILED = auto()


class MultiCameraProcessingPresenter:
    """Drives process_synchronized_recording with live FrameData signals."""

    def __init__(
        self,
        recording_dir: Path,
        camera_array: CameraArray,
        tracker: Tracker,
        task_manager: Optional[TaskManager] = None,
        subsample: int = 1,
    ):
        """The tracker runs on its own device."""
        self.recording_dir = Path(recording_dir)
        self.camera_array = camera_array
        self.tracker = tracker
        self.subsample = subsample
        self._tasks = task_manager or TaskManager(max_workers=1)
        self._busy = False
        self._error: Optional[str] = None
        self._points: Optional[ImagePoints] = None

        self.state_changed = Signal("state_changed")
        self.frame_data_ready = Signal("frame_data_ready")  # (sync_index, {cam: FrameData})
        self.progress_updated = Signal("progress_updated")  # (done, total)
        self.points_ready = Signal("points_ready")
        self.error_occurred = Signal("error_occurred")

    @property
    def state(self) -> ProcessingState:
        if self._busy:
            return ProcessingState.PROCESSING
        if self._error is not None:
            return ProcessingState.FAILED
        if self._points is not None:
            return ProcessingState.COMPLETE
        return ProcessingState.IDLE

    @property
    def image_points(self) -> Optional[ImagePoints]:
        return self._points

    def run(self, block: bool = False):
        from caliscope_tpu_torch.pipelines.process_recording import process_synchronized_recording

        if self._busy:
            return None
        self._busy = True
        self._error = None
        self.state_changed.emit(self.state)

        def work(cancellation_token=None):
            synced = SynchronizedTimestamps.from_video_paths(
                {cid: self.recording_dir / f"cam_{cid}.mp4" for cid in self.camera_array.cameras}
            )
            return process_synchronized_recording(
                self.recording_dir,
                self.camera_array.cameras,
                self.tracker,
                synced,
                subsample=self.subsample,
                on_frame_data=lambda si, fd: self.frame_data_ready.emit(si, fd),
                on_progress=lambda i, n: self.progress_updated.emit(i, n),
                token=cancellation_token,
            )

        def on_done(fut):
            self._busy = False
            try:
                self._points = fut.result()
                self.points_ready.emit(self._points)
            except Exception as e:
                self._error = str(e)
                self.error_occurred.emit(str(e))
            self.state_changed.emit(self.state)

        handle = self._tasks.submit(work, name="multicam_processing")
        handle.future.add_done_callback(on_done)
        if block:
            handle.future.exception()
        return handle


class ReconstructionPresenter:
    """Drives reconstruct_xyz over extracted points."""

    def __init__(
        self,
        camera_array: CameraArray,
        tracker: Tracker,
        output_dir: Path,
        task_manager: Optional[TaskManager] = None,
        device=None,
    ):
        self.camera_array = camera_array
        self.device = device  # triangulation's device: CUDA unless named
        self.tracker = tracker
        self.output_dir = Path(output_dir)
        self._tasks = task_manager or TaskManager(max_workers=1)
        self._busy = False
        self._error: Optional[str] = None
        self._done = False

        self.state_changed = Signal("state_changed")
        self.reconstruction_completed = Signal("reconstruction_completed")
        self.error_occurred = Signal("error_occurred")

    @property
    def state(self) -> ProcessingState:
        if self._busy:
            return ProcessingState.PROCESSING
        if self._error is not None:
            return ProcessingState.FAILED
        if self._done:
            return ProcessingState.COMPLETE
        return ProcessingState.IDLE

    def run(self, image_points: ImagePoints, block: bool = False):
        from caliscope_tpu_torch.reconstruction import reconstruct_xyz

        if self._busy:
            return None
        self._busy = True
        self._error = None
        self.state_changed.emit(self.state)

        def work():
            reconstruct_xyz(image_points, self.camera_array, self.tracker, self.output_dir, device=self.device)

        def on_done(fut):
            self._busy = False
            try:
                fut.result()
                self._done = True
                self.reconstruction_completed.emit(self.output_dir)
            except Exception as e:
                self._error = str(e)
                self.error_occurred.emit(str(e))
            self.state_changed.emit(self.state)

        handle = self._tasks.submit(work, name="reconstruction")
        handle.future.add_done_callback(on_done)
        if block:
            handle.future.exception()
        return handle
