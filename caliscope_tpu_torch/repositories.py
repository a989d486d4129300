"""Typed persistence gateways per artifact.

Port of caliscope_tpu/repositories.py (host code): every file it writes is
the JAX package's byte for byte, and each package loads the other's, so a
workspace moves between them unchanged. A capture volume loads on the
device the caller names (CUDA unless named).

Parity: reference src/caliscope/repositories/ (CameraArrayRepository,
CaptureVolumeRepository:27, CalibrationTargetsRepository:37 + TargetRouting:29,
ProjectSettingsRepository, IntrinsicReportRepository). Every write is atomic
(persistence.py); persistence errors surface as ValueError at this boundary.

Workspace layout (file-compatible with the reference so projects port over):
    workspace/
        project_settings.toml
        camera_array.toml
        calibration/targets/{routing.toml, charuco_intrinsic.toml, ...}
        calibration/extrinsic/{TRACKER}/xy_{TRACKER}.csv
        capture_volume/{camera_array.toml, image_points.csv, world_points.csv,
                        constraints.toml}
        intrinsic/reports/cam_{N}.toml
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from caliscope_tpu_torch import persistence
from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.exceptions import PersistenceError
from caliscope_tpu_torch.pipelines.calibrate_intrinsics import IntrinsicCalibrationReport
from caliscope_tpu_torch.targets import ArucoMarkerSet, Charuco, Chessboard
from caliscope_tpu_torch.volume import CaptureVolume

logger = logging.getLogger(__name__)


class CameraArrayRepository:
    """camera_array.toml gateway."""

    def __init__(self, camera_array_path: Path | str):
        self.path = Path(camera_array_path)

    def exists(self) -> bool:
        return self.path.exists()

    def load(self) -> CameraArray:
        try:
            return CameraArray.from_toml(self.path)
        except PersistenceError as e:
            raise ValueError(f"Failed to load camera array: {e}") from e

    def save(self, camera_array: CameraArray) -> None:
        try:
            camera_array.to_toml(self.path)
        except PersistenceError as e:
            raise ValueError(f"Failed to save camera array: {e}") from e

    def save_camera(self, camera: CameraData) -> None:
        """Update one camera, preserving the rest of the array."""
        array = self.load() if self.exists() else CameraArray({})
        array.cameras[camera.cam_id] = camera
        self.save(CameraArray(array.cameras))


class CaptureVolumeRepository:
    """capture_volume/ directory gateway (camera_array.toml + image_points.csv
    + world_points.csv + constraints.toml)."""

    def __init__(self, base_path: Path | str):
        self.base_path = Path(base_path)

    def exists(self) -> bool:
        return (self.base_path / "camera_array.toml").exists()

    def load(self, device=None) -> CaptureVolume:
        try:
            return CaptureVolume.load(self.base_path, device=device)
        except (PersistenceError, FileNotFoundError) as e:
            raise ValueError(f"Failed to load capture volume: {e}") from e

    def save(self, capture_volume: CaptureVolume) -> None:
        try:
            capture_volume.save(self.base_path)
        except PersistenceError as e:
            raise ValueError(f"Failed to save capture volume: {e}") from e


@dataclass(frozen=True)
class TargetRouting:
    """Which target type serves which calibration stage
    (reference calibration_targets_repository.py:29)."""

    intrinsic: str = "charuco"  # charuco | chessboard
    extrinsic: str = "charuco"  # charuco | aruco | chessboard
    extrinsic_charuco_same_as_intrinsic: bool = True


class CalibrationTargetsRepository:
    """calibration/targets/ gateway: routing + per-type target configs.

    File names and routing keys mirror the reference layout exactly
    (reference calibration_targets_repository.py:44-51, 66-93) so a
    reference workspace drops in unchanged: config.toml with
    {intrinsic,extrinsic}_target_type keys, intrinsic_charuco.toml,
    extrinsic_charuco.toml, chessboard.toml, aruco_marker_set.toml.
    Legacy single-file workspaces (a root-level charuco.toml, the layout
    of the project's committed test sessions) are read as a fallback.
    """

    def __init__(self, targets_dir: Path | str, legacy_root: Path | str | None = None):
        self.targets_dir = Path(targets_dir)
        self.legacy_root = Path(legacy_root) if legacy_root is not None else None

    def _routing_path(self) -> Path:
        return self.targets_dir / "config.toml"

    def get_routing(self) -> TargetRouting:
        if not self._routing_path().exists():
            return TargetRouting()
        d = persistence.load_toml(self._routing_path())
        return TargetRouting(
            intrinsic=d.get("intrinsic_target_type", "charuco"),
            extrinsic=d.get("extrinsic_target_type", "charuco"),
            extrinsic_charuco_same_as_intrinsic=d.get("extrinsic_charuco_same_as_intrinsic", True),
        )

    def save_routing(self, routing: TargetRouting) -> None:
        persistence.safe_write_toml(
            {
                "intrinsic_target_type": routing.intrinsic,
                "extrinsic_target_type": routing.extrinsic,
                "extrinsic_charuco_same_as_intrinsic": routing.extrinsic_charuco_same_as_intrinsic,
            },
            self._routing_path(),
        )

    # charuco ----------------------------------------------------------------
    def _legacy_charuco_path(self) -> Path | None:
        if self.legacy_root is not None:
            p = self.legacy_root / "charuco.toml"
            if p.exists():
                return p
        return None

    def load_intrinsic_charuco(self) -> Charuco:
        path = self.targets_dir / "intrinsic_charuco.toml"
        if not path.exists():
            legacy = self._legacy_charuco_path()
            if legacy is not None:
                return Charuco.from_toml(legacy)
        return Charuco.from_toml(path)

    def save_intrinsic_charuco(self, charuco: Charuco) -> None:
        charuco.to_toml(self.targets_dir / "intrinsic_charuco.toml")

    def intrinsic_charuco_exists(self) -> bool:
        return (
            self.targets_dir / "intrinsic_charuco.toml"
        ).exists() or self._legacy_charuco_path() is not None

    def load_extrinsic_charuco(self) -> Charuco:
        routing = self.get_routing()
        if routing.extrinsic_charuco_same_as_intrinsic:
            return self.load_intrinsic_charuco()
        return Charuco.from_toml(self.targets_dir / "extrinsic_charuco.toml")

    def save_extrinsic_charuco(self, charuco: Charuco) -> None:
        charuco.to_toml(self.targets_dir / "extrinsic_charuco.toml")

    # chessboard -------------------------------------------------------------
    def load_chessboard(self) -> Chessboard:
        return Chessboard.from_toml(self.targets_dir / "chessboard.toml")

    def save_chessboard(self, chessboard: Chessboard) -> None:
        chessboard.to_toml(self.targets_dir / "chessboard.toml")

    def chessboard_exists(self) -> bool:
        return (self.targets_dir / "chessboard.toml").exists()

    # aruco marker set -------------------------------------------------------
    def load_aruco_marker_set(self) -> ArucoMarkerSet:
        return ArucoMarkerSet.from_toml(self.targets_dir / "aruco_marker_set.toml")

    def save_aruco_marker_set(self, marker_set: ArucoMarkerSet) -> None:
        marker_set.to_toml(self.targets_dir / "aruco_marker_set.toml")

    def aruco_marker_set_exists(self) -> bool:
        return (self.targets_dir / "aruco_marker_set.toml").exists()

    def get_extrinsic_tracker_name(self) -> str:
        return {"charuco": "CHARUCO", "aruco": "ARUCO", "chessboard": "CHESSBOARD"}[self.get_routing().extrinsic]

    def initialize_defaults(self) -> None:
        if not self._routing_path().exists():
            self.save_routing(TargetRouting())
        if not self.intrinsic_charuco_exists():
            self.save_intrinsic_charuco(Charuco(rows=4, columns=5, square_size_m=0.054))


class ProjectSettingsRepository:
    """project_settings.toml gateway with in-memory cache."""

    def __init__(self, settings_path: Path | str):
        self.path = Path(settings_path)
        self._cache: dict[str, Any] = {}
        self.refresh()

    def refresh(self) -> None:
        if self.path.exists():
            try:
                self._cache = persistence.load_toml(self.path)
            except PersistenceError as e:
                raise ValueError(f"Failed to load project settings: {e}") from e
        else:
            self._cache = {}

    def save(self, settings: dict[str, Any]) -> None:
        try:
            persistence.safe_write_toml({k: v for k, v in settings.items() if v is not None}, self.path)
            self._cache = dict(settings)
        except PersistenceError as e:
            raise ValueError(f"Failed to save project settings: {e}") from e

    def get(self, key: str, default: Any = None) -> Any:
        return self._cache.get(key, default)

    def set(self, key: str, value: Any) -> None:
        settings = dict(self._cache)
        settings[key] = value
        self.save(settings)

    @property
    def all(self) -> dict[str, Any]:
        return dict(self._cache)


class IntrinsicReportRepository:
    """intrinsic/reports/cam_{N}.toml gateway."""

    def __init__(self, reports_dir: Path | str):
        self.reports_dir = Path(reports_dir)

    def _cam_path(self, cam_id: int) -> Path:
        return self.reports_dir / f"cam_{cam_id}.toml"

    def save(self, cam_id: int, report: IntrinsicCalibrationReport) -> None:
        persistence.safe_write_toml(
            {
                "rmse": report.rmse,
                "frames_used": report.frames_used,
                "coverage_fraction": report.coverage_fraction,
                "edge_coverage_fraction": report.edge_coverage_fraction,
                "corner_coverage_fraction": report.corner_coverage_fraction,
                "orientation_sufficient": report.orientation_sufficient,
                "orientation_count": report.orientation_count,
                "selected_frames": list(report.selected_frames),
            },
            self._cam_path(cam_id),
        )

    def load(self, cam_id: int) -> Optional[IntrinsicCalibrationReport]:
        p = self._cam_path(cam_id)
        if not p.exists():
            return None
        try:
            d = persistence.load_toml(p)
            return IntrinsicCalibrationReport(
                rmse=float(d["rmse"]),
                frames_used=int(d["frames_used"]),
                coverage_fraction=float(d["coverage_fraction"]),
                edge_coverage_fraction=float(d["edge_coverage_fraction"]),
                corner_coverage_fraction=float(d["corner_coverage_fraction"]),
                orientation_sufficient=bool(d["orientation_sufficient"]),
                orientation_count=int(d["orientation_count"]),
                selected_frames=tuple(d["selected_frames"]),
            )
        except (PersistenceError, KeyError, TypeError) as e:
            logger.warning(f"Corrupt intrinsic report for cam {cam_id}: {e}")
            return None

    def load_all(self) -> dict[int, IntrinsicCalibrationReport]:
        out = {}
        if self.reports_dir.exists():
            for p in sorted(self.reports_dir.glob("cam_*.toml")):
                try:
                    cam_id = int(p.stem.split("_")[1])
                except (IndexError, ValueError):
                    continue
                rep = self.load(cam_id)
                if rep is not None:
                    out[cam_id] = rep
        return out

    def delete(self, cam_id: int) -> bool:
        p = self._cam_path(cam_id)
        if p.exists():
            p.unlink()
            return True
        return False
