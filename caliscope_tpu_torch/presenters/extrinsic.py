"""Extrinsic-calibration presenter: the workflow state machine behind the

Port of caliscope_tpu/presenters/extrinsic.py; the calibration runs on
the presenter's device (CUDA unless device="cpu"), later operations on
the volume's.
Extrinsics tab.

Parity: reference src/caliscope/gui/presenters/extrinsic_calibration_presenter.py
(ExtrinsicCalibrationState:46, FilterPreviewData:59, OriginOption:143,
run_calibration:335 in a task thread, filter_by_percentile:421,
filter preview :456, rotate:489, align_to_origin:506, origin options :529).
State is computed from internal reality, never stored separately.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum, auto
from typing import Optional

import numpy as np

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.constraints import ConstraintSet
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, ImagePoints
from caliscope_tpu_torch.pipelines import CalibrationRun, calibrate_extrinsics, refresh_run
from caliscope_tpu_torch.presenters.signal import Signal
from caliscope_tpu_torch.tasks import TaskManager
from caliscope_tpu_torch.volume import CaptureVolume

logger = logging.getLogger(__name__)


class ExtrinsicCalibrationState(Enum):
    NO_DATA = auto()
    NEEDS_CALIBRATION = auto()
    CALIBRATING = auto()
    CALIBRATED = auto()
    FAILED = auto()


@dataclass(frozen=True)
class FilterPreviewData:
    """Error histogram data for the filter-threshold slider."""

    errors: np.ndarray  # sorted euclidean errors (px)

    @classmethod
    def empty(cls) -> "FilterPreviewData":
        return cls(np.zeros(0))

    def percent_above_threshold(self, threshold: float) -> float:
        if len(self.errors) == 0:
            return 0.0
        return float(100.0 * np.mean(self.errors > threshold))

    def percentile_error(self, pct: float) -> float:
        return float(np.percentile(self.errors, pct)) if len(self.errors) else 0.0


@dataclass(frozen=True)
class OriginOption:
    """A marker instance the volume can be aligned to."""

    object_id: int
    sync_index: Optional[int]  # None for static markers
    label: str


class ExtrinsicCalibrationPresenter:
    def __init__(
        self,
        image_points: Optional[ImagePoints],
        camera_array: Optional[CameraArray],
        constraints: Optional[ConstraintSet],
        task_manager: Optional[TaskManager] = None,
        device=None,
    ):
        self._image_points = image_points
        self._device = device
        self._camera_array = camera_array
        self._constraints = constraints
        self._tasks = task_manager or TaskManager(max_workers=1)
        self._run: Optional[CalibrationRun] = None
        self._calibrating = False
        self._error: Optional[str] = None
        self._refine_intrinsics = True

        self.state_changed = Signal("state_changed")
        self.progress_updated = Signal("progress_updated")
        self.capture_volume_changed = Signal("capture_volume_changed")
        self.calibration_run_updated = Signal("calibration_run_updated")
        self.error_occurred = Signal("error_occurred")

    # ---- computed state -----------------------------------------------------
    @property
    def state(self) -> ExtrinsicCalibrationState:
        if self._calibrating:
            return ExtrinsicCalibrationState.CALIBRATING
        if self._error is not None:
            return ExtrinsicCalibrationState.FAILED
        if self._run is not None:
            return ExtrinsicCalibrationState.CALIBRATED
        if self.has_extraction_data:
            return ExtrinsicCalibrationState.NEEDS_CALIBRATION
        return ExtrinsicCalibrationState.NO_DATA

    @property
    def has_extraction_data(self) -> bool:
        return self._image_points is not None and len(self._image_points) > 0

    @property
    def capture_volume(self) -> Optional[CaptureVolume]:
        return self._run.capture_volume if self._run else None

    @property
    def calibration_run(self) -> Optional[CalibrationRun]:
        return self._run

    @property
    def refine_intrinsics(self) -> bool:
        return self._refine_intrinsics

    def set_refine_intrinsics(self, enabled: bool) -> None:
        self._refine_intrinsics = enabled

    def set_extraction_data(self, image_points: ImagePoints) -> None:
        self._image_points = image_points
        self._run = None
        self._error = None
        self.state_changed.emit(self.state)

    # ---- calibration --------------------------------------------------------
    def run_calibration(self, filter_percentile: float = 2.5, block: bool = False):
        """Run calibrate_extrinsics in a task thread (or inline)."""
        if self.state is ExtrinsicCalibrationState.CALIBRATING:
            return None
        if not self.has_extraction_data or self._camera_array is None:
            self._error = "No extraction data"
            self.state_changed.emit(self.state)
            return None
        self._calibrating = True
        self._error = None
        self.state_changed.emit(self.state)

        def work(progress=None, cancellation_token=None):
            return calibrate_extrinsics(
                self._image_points,
                self._camera_array,
                self._constraints,
                refine_intrinsics=self._refine_intrinsics,
                filter_percentile=filter_percentile,
                progress=progress,
                cancellation_token=cancellation_token,
                device=self._device,
            )

        def on_done(fut):
            self._calibrating = False
            try:
                self._run = fut.result()
                self.calibration_run_updated.emit(self._run)
                self.capture_volume_changed.emit(self._run.capture_volume)
            except Exception as e:
                self._error = str(e)
                self.error_occurred.emit(str(e))
            self.state_changed.emit(self.state)

        handle = self._tasks.submit(
            work, name="extrinsic_calibration",
            on_progress=lambda p, m: self.progress_updated.emit(p, m),
        )
        handle.future.add_done_callback(on_done)
        if block:
            handle.future.exception()  # wait
        return handle

    # ---- post-calibration operations ---------------------------------------
    def _update_volume(self, volume: CaptureVolume, reoptimized: bool = False) -> None:
        assert self._run is not None
        self._run = refresh_run(self._run, volume)
        self.calibration_run_updated.emit(self._run)
        self.capture_volume_changed.emit(volume)
        self.state_changed.emit(self.state)

    def get_filter_preview(self) -> FilterPreviewData:
        v = self.capture_volume
        if v is None:
            return FilterPreviewData.empty()
        return FilterPreviewData(np.sort(v.reprojection_report.raw_errors.euclidean_error))

    def filter_by_percentile(self, percentile: float) -> None:
        v = self.capture_volume
        if v is None:
            return
        self._update_volume(v.filter_by_percentile_error(percentile).optimize(refine_intrinsics=False))

    def filter_by_threshold(self, max_error_pixels: float) -> None:
        v = self.capture_volume
        if v is None:
            return
        self._update_volume(v.filter_by_absolute_error(max_error_pixels).optimize(refine_intrinsics=False))

    def rotate(self, axis: str, degrees: float) -> None:
        v = self.capture_volume
        if v is not None:
            self._update_volume(v.rotate(axis, degrees))

    def translate(self, x: float = 0.0, y: float = 0.0, z: float = 0.0) -> None:
        v = self.capture_volume
        if v is not None:
            self._update_volume(v.translate(x, y, z))

    def align_to_origin(self, object_id: int, sync_index: Optional[int]) -> None:
        v = self.capture_volume
        if v is not None:
            self._update_volume(v.align_to_object(sync_index, object_id))

    def orient_gravity(self) -> None:
        """Consensus gravity-up -> +Z (reference origin options)."""
        v = self.capture_volume
        if v is not None:
            self._update_volume(v.oriented())

    def ground(self) -> None:
        """Floor (1st-percentile of point heights) to z=0."""
        v = self.capture_volume
        if v is not None:
            self._update_volume(v.grounded())

    def center(self) -> None:
        """Centroid of the world points to the origin."""
        v = self.capture_volume
        if v is not None:
            self._update_volume(v.centered())

    def get_origin_options(self) -> list[OriginOption]:
        """Marker instances suitable as the world origin."""
        v = self.capture_volume
        if v is None:
            return []
        static_ids = v.constraints.static_object_ids if v.constraints else frozenset()
        options: list[OriginOption] = []
        wp = v.world_points
        for oid in sorted(int(o) for o in np.unique(wp.object_id)):
            if oid in static_ids:
                options.append(OriginOption(oid, None, f"static marker {oid}"))
            else:
                syncs = np.unique(wp.sync_index[(wp.object_id == oid) & (wp.sync_index != STATIC_SYNC_INDEX)])
                counts = [
                    int(np.sum((wp.object_id == oid) & (wp.sync_index == s))) for s in syncs
                ]
                if len(syncs):
                    best = syncs[int(np.argmax(counts))]
                    options.append(OriginOption(oid, int(best), f"object {oid} @ sync {int(best)}"))
        return options
