"""Headless workspace coordination: directory conventions, workflow status,
and end-to-end project orchestration.

Port of caliscope_tpu/workspace.py. A workspace runs its trackers and
solvers on the device it is given (CUDA unless the caller passes
device="cpu"); its files and folders are the JAX package's.

Parity: reference src/caliscope/workspace_coordinator.py:54 (repository
wiring, tab-enablement predicates, tracker factories, calibration
persistence), workspace_guide.py (directory inspection) and
core/workflow_status.py:22 (WorkflowStatus/StepStatus). The Qt pieces
(QFileSystemWatcher, signals) are absent — this is the scripting/automation
equivalent the GUI layers on top of.

Workspace layout (reference-compatible):
    workspace/
        project_settings.toml
        camera_array.toml
        calibration/intrinsic/cam_N.mp4
        calibration/extrinsic/cam_N.mp4 (+ xy_{TRACKER}.csv after extraction)
        calibration/targets/...
        capture_volume/...
        intrinsic/reports/cam_N.toml
        recordings/<name>/cam_N.mp4
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum, auto
from pathlib import Path
from typing import Optional

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.constraints import ConstraintSet
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.repositories import (
    CalibrationTargetsRepository,
    CameraArrayRepository,
    CaptureVolumeRepository,
    IntrinsicReportRepository,
    ProjectSettingsRepository,
)

logger = logging.getLogger(__name__)


class StepStatus(Enum):
    NOT_STARTED = auto()
    INCOMPLETE = auto()
    COMPLETE = auto()
    AVAILABLE = auto()


@dataclass(frozen=True)
class WorkflowStatus:
    """Snapshot of calibration workflow progress, computed from the
    filesystem ground truth (reference workflow_status.py:22)."""

    camera_count: int
    charuco_configured: bool
    intrinsic_videos_available: bool
    intrinsic_videos_missing: list[int]
    intrinsic_calibration_complete: bool
    cameras_needing_calibration: list[int]
    cameras_have_resolution: bool
    extrinsic_videos_available: bool
    extrinsic_videos_missing: list[int]
    extrinsic_2d_extraction_complete: bool
    extrinsic_calibration_complete: bool
    recordings_available: bool
    recording_names: list[str]

    @property
    def intrinsic_step_status(self) -> StepStatus:
        if self.intrinsic_calibration_complete:
            return StepStatus.COMPLETE
        if self.intrinsic_videos_available:
            return StepStatus.AVAILABLE
        return StepStatus.NOT_STARTED

    @property
    def extrinsic_2d_step_status(self) -> StepStatus:
        if self.extrinsic_2d_extraction_complete:
            return StepStatus.COMPLETE
        if self.extrinsic_videos_available and self.cameras_have_resolution:
            return StepStatus.INCOMPLETE
        return StepStatus.NOT_STARTED

    @property
    def extrinsic_calibration_step_status(self) -> StepStatus:
        if self.extrinsic_calibration_complete:
            return StepStatus.COMPLETE
        if self.extrinsic_2d_extraction_complete:
            return StepStatus.INCOMPLETE
        return StepStatus.NOT_STARTED


class Workspace:
    """Project root wiring: repositories + orchestration of the pipelines."""

    def __init__(self, workspace_dir: Path | str, device=None):
        self.root = Path(workspace_dir)
        self.device = device  # where trackers and solvers run: CUDA unless named
        self.calibration_dir = self.root / "calibration"
        self.intrinsic_dir = self.calibration_dir / "intrinsic"
        self.extrinsic_dir = self.calibration_dir / "extrinsic"
        self.recording_dir = self.root / "recordings"
        self.cameras = CameraArrayRepository(self.root / "camera_array.toml")
        self.capture_volume = CaptureVolumeRepository(self.root / "capture_volume")
        self.targets = CalibrationTargetsRepository(
            self.calibration_dir / "targets", legacy_root=self.root
        )
        self.settings = ProjectSettingsRepository(self.root / "project_settings.toml")
        self.intrinsic_reports = IntrinsicReportRepository(self.root / "intrinsic" / "reports")

    @classmethod
    def create(cls, workspace_dir: Path | str, device=None) -> "Workspace":
        """Initialize a new workspace skeleton with default targets."""
        ws = cls(workspace_dir, device=device)
        for d in (ws.intrinsic_dir, ws.extrinsic_dir, ws.recording_dir):
            d.mkdir(parents=True, exist_ok=True)
        ws.targets.initialize_defaults()
        if not ws.settings.path.exists():
            ws.settings.save({"version": 1})
        return ws

    # ---- directory inspection ----------------------------------------------
    @staticmethod
    def _cam_ids_in_dir(directory: Path) -> list[int]:
        if not directory.exists():
            return []
        out = []
        for f in directory.iterdir():
            if f.stem.startswith("cam_") and f.suffix == ".mp4":
                try:
                    out.append(int(f.stem.split("_")[1]))
                except (ValueError, IndexError):
                    logger.warning(f"Skipping malformed filename: {f.name}")
        return sorted(out)

    def get_cam_ids(self) -> list[int]:
        """Authoritative camera set = extrinsic directory contents."""
        return self._cam_ids_in_dir(self.extrinsic_dir)

    def video_path(self, stage: str, cam_id: int) -> Path:
        d = {"intrinsic": self.intrinsic_dir, "extrinsic": self.extrinsic_dir}[stage]
        return d / f"cam_{cam_id}.mp4"

    def recording_names(self) -> list[str]:
        if not self.recording_dir.exists():
            return []
        return sorted(d.name for d in self.recording_dir.iterdir() if d.is_dir())

    def xy_csv_path(self, tracker_name: str) -> Path:
        return self.extrinsic_dir / tracker_name.upper() / f"xy_{tracker_name.upper()}.csv"

    # ---- status -------------------------------------------------------------
    def get_workflow_status(self) -> WorkflowStatus:
        cam_ids = self.get_cam_ids()
        intr_ids = set(self._cam_ids_in_dir(self.intrinsic_dir))
        intr_missing = sorted(set(cam_ids) - intr_ids)
        array = self.cameras.load() if self.cameras.exists() else CameraArray({})
        needing = [
            cid for cid in cam_ids
            if cid not in array.cameras or not array.cameras[cid].has_intrinsics
        ]
        have_res = bool(cam_ids) and all(
            cid in array.cameras and array.cameras[cid].size is not None for cid in cam_ids
        )
        tracker_name = self.targets.get_extrinsic_tracker_name()
        xy_exists = self.xy_csv_path(tracker_name).exists()
        extrinsic_done = self.capture_volume.exists() or (
            bool(array.cameras) and array.all_extrinsics_calibrated
        )
        return WorkflowStatus(
            camera_count=len(cam_ids),
            charuco_configured=self.targets.intrinsic_charuco_exists(),
            intrinsic_videos_available=bool(cam_ids) and not intr_missing,
            intrinsic_videos_missing=intr_missing,
            intrinsic_calibration_complete=bool(cam_ids) and not needing,
            cameras_needing_calibration=needing,
            cameras_have_resolution=have_res,
            extrinsic_videos_available=bool(cam_ids),
            extrinsic_videos_missing=[],
            extrinsic_2d_extraction_complete=xy_exists,
            extrinsic_calibration_complete=extrinsic_done,
            recordings_available=bool(self.recording_names()),
            recording_names=self.recording_names(),
        )

    # ---- tracker factories --------------------------------------------------
    def make_intrinsic_tracker(self):
        from caliscope_tpu_torch.trackers import CharucoTracker, ChessboardTracker

        routing = self.targets.get_routing()
        if routing.intrinsic == "chessboard":
            return ChessboardTracker(self.targets.load_chessboard(), device=self.device)
        return CharucoTracker(self.targets.load_intrinsic_charuco(), device=self.device)

    def make_extrinsic_tracker(self):
        from caliscope_tpu_torch.trackers import ArucoTracker, CharucoTracker, ChessboardTracker

        routing = self.targets.get_routing()
        if routing.extrinsic == "aruco":
            return ArucoTracker(self.targets.load_aruco_marker_set(), device=self.device)
        if routing.extrinsic == "chessboard":
            return ChessboardTracker(self.targets.load_chessboard(), device=self.device)
        return CharucoTracker(self.targets.load_extrinsic_charuco(), device=self.device)

    def make_extrinsic_constraints(self) -> Optional[ConstraintSet]:
        routing = self.targets.get_routing()
        if routing.extrinsic == "aruco":
            return ConstraintSet.from_marker_set(self.targets.load_aruco_marker_set())
        if routing.extrinsic == "chessboard":
            cb = self.targets.load_chessboard()
            return ConstraintSet.from_chessboard(cb) if cb.square_size_m else None
        return ConstraintSet.from_charuco(self.targets.load_extrinsic_charuco())

    # ---- orchestration ------------------------------------------------------
    def ensure_cameras_from_videos(self) -> CameraArray:
        """Create/refresh CameraData entries with resolution from the videos."""
        from caliscope_tpu_torch.media import read_video_properties

        array = self.cameras.load() if self.cameras.exists() else CameraArray({})
        for cid in self.get_cam_ids():
            props = read_video_properties(self.video_path("extrinsic", cid))
            if cid in array.cameras:
                array.cameras[cid].size = props.size
            else:
                array.cameras[cid] = CameraData(cam_id=cid, size=props.size)
        array = CameraArray(array.cameras)
        self.cameras.save(array)
        return array

    def run_intrinsic_calibration(self, cam_id: int, frame_step: int = 5, progress=None):
        """Extract from the camera's intrinsic video + calibrate + persist."""
        from caliscope_tpu_torch.api import calibrate_intrinsics, extract_image_points
        from caliscope_tpu_torch.media import read_video_properties

        video = self.video_path("intrinsic", cam_id)
        if not video.exists():
            raise CalibrationError(f"No intrinsic video for camera {cam_id} at {video}")
        tracker = self.make_intrinsic_tracker()
        points = extract_image_points(video, cam_id, tracker, frame_step=frame_step, progress=progress)
        array = self.cameras.load() if self.cameras.exists() else CameraArray({})
        cam = array.cameras.get(cam_id)
        if cam is None:
            props = read_video_properties(video)
            cam = CameraData(cam_id=cam_id, size=props.size)
        output = calibrate_intrinsics(points, cam, device=self.device)
        self.cameras.save_camera(output.camera)
        self.intrinsic_reports.save(cam_id, output.report)
        return output

    def extract_extrinsic_points(self, frame_step: int = 1, progress=None) -> ImagePoints:
        """Synchronized multicam extraction + persist the xy CSV."""
        from caliscope_tpu_torch.api import extract_image_points_multicam

        tracker = self.make_extrinsic_tracker()
        videos = {cid: self.video_path("extrinsic", cid) for cid in self.get_cam_ids()}
        ts = self.extrinsic_dir / "timestamps.csv"
        points = extract_image_points_multicam(
            videos, tracker, frame_step=frame_step,
            timestamps=ts if ts.exists() else None, progress=progress,
        )
        points.to_csv(self.xy_csv_path(tracker.name))
        return points

    def run_extrinsic_calibration(self, image_points: Optional[ImagePoints] = None, progress=None, **kwargs):
        """calibrate_extrinsics over the workspace's data; persists results."""
        from caliscope_tpu_torch.pipelines import calibrate_extrinsics

        tracker_name = self.targets.get_extrinsic_tracker_name()
        if image_points is None:
            csv = self.xy_csv_path(tracker_name)
            if not csv.exists():
                raise CalibrationError(
                    f"No extracted 2D points at {csv}; run extract_extrinsic_points() first."
                )
            image_points = ImagePoints.from_csv(csv)
        cameras = self.ensure_cameras_from_videos() if not self.cameras.exists() else self.cameras.load()
        constraints = self.make_extrinsic_constraints()
        run = calibrate_extrinsics(image_points, cameras, constraints, progress=progress, device=self.device, **kwargs)
        self.capture_volume.save(run.capture_volume)
        self.cameras.save(run.capture_volume.camera_array)
        return run

    def reconstruct_recording(self, name: str, tracker=None, frame_step: int = 1, progress=None) -> None:
        """Extract + triangulate + export one recording directory."""
        from caliscope_tpu_torch.api import extract_image_points_multicam
        from caliscope_tpu_torch.reconstruction import reconstruct_xyz

        rec_dir = self.recording_dir / name
        videos = {cid: rec_dir / f"cam_{cid}.mp4" for cid in self._cam_ids_in_dir(rec_dir)}
        if not videos:
            raise CalibrationError(f"No cam_N.mp4 videos in recording {rec_dir}")
        tracker = tracker or self.make_extrinsic_tracker()
        ts = rec_dir / "timestamps.csv"
        points = extract_image_points_multicam(
            videos, tracker, frame_step=frame_step,
            timestamps=ts if ts.exists() else None, progress=progress,
        )
        cameras = self.cameras.load()
        reconstruct_xyz(points, cameras, tracker, rec_dir / tracker.name, device=self.device)


class WorkspaceWatcher:
    """Poll-based filesystem watcher for workspace state changes.

    Plays the role of the reference's QFileSystemWatcher wiring
    (workspace_coordinator.py:121) without a Qt dependency: a daemon thread
    samples the modification state of the workspace's load-bearing paths
    (camera array, capture volume, target definitions, stage directories)
    and invokes `on_change(changed_keys)` from the watcher thread whenever
    the fingerprint moves. GUI callers route the callback through their
    signal bridge; headless callers (tests, long-running services) use it
    directly. Polling (default 1 s) is deliberate: inotify descriptors leak
    across the many short-lived test workspaces, and calibration artifacts
    change at human timescales.
    """

    def __init__(self, workspace: Workspace, on_change, poll_interval: float = 1.0):
        import threading

        self.workspace = workspace
        self.on_change = on_change
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._snapshot = self._fingerprint()

    # ---- fingerprinting -------------------------------------------------------
    def _stat_key(self, path: Path):
        try:
            st = path.stat()
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _dir_key(self, path: Path):
        if not path.is_dir():
            return None
        try:
            return tuple(sorted(p.name for p in path.iterdir()))
        except OSError:
            return None

    def _fingerprint(self) -> dict:
        ws = self.workspace
        return {
            "camera_array": self._stat_key(ws.cameras.path),
            "capture_volume": self._stat_key(ws.capture_volume.base_path / "camera_array.toml"),
            "targets": self._dir_key(ws.targets.targets_dir),
            "intrinsic_videos": self._dir_key(ws.intrinsic_dir),
            "extrinsic_videos": self._dir_key(ws.extrinsic_dir),
            "recordings": self._dir_key(ws.recording_dir),
            "settings": self._stat_key(ws.settings.path),
        }

    # ---- lifecycle --------------------------------------------------------------
    def poll_once(self) -> list[str]:
        """One comparison pass; returns the changed keys (and fires the
        callback when non-empty). Used by tests and by the thread loop."""
        now = self._fingerprint()
        changed = [k for k in now if now[k] != self._snapshot.get(k)]
        self._snapshot = now
        if changed:
            try:
                self.on_change(changed)
            except Exception:
                logger.exception("WorkspaceWatcher callback failed")
        return changed

    def start(self) -> "WorkspaceWatcher":
        import threading

        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(self.poll_interval):
                self.poll_once()

        self._thread = threading.Thread(target=loop, name="workspace-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
