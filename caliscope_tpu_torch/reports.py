"""Calibration quality report objects.

Parity: reference src/caliscope/core/reprojection_report.py (ReprojectionReport:6)
and capture_volume.py OptimizationStatus:46. Raw per-observation errors are
kept as plain arrays (keys + error columns) rather than a pandas DataFrame.

Host-only copy of caliscope_tpu/reports.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class OptimizationStatus:
    """Result metadata from bundle adjustment (cleared by filter methods)."""

    converged: bool
    termination_reason: str
    iterations: int
    final_cost: float
    bound_warnings: tuple = ()


@dataclass(frozen=True)
class RawErrors:
    """Per matched observation: identity keys + pixel reprojection errors."""

    sync_index: np.ndarray
    cam_id: np.ndarray
    object_id: np.ndarray
    keypoint_id: np.ndarray
    error_xy: np.ndarray  # (N,2)

    @property
    def euclidean_error(self) -> np.ndarray:
        return np.sqrt(np.sum(self.error_xy**2, axis=1))

    def __len__(self) -> int:
        return len(self.sync_index)


@dataclass(frozen=True)
class ReprojectionReport:
    overall_rmse: float
    by_camera: dict[int, float]
    by_point: dict[tuple[int, int], float]
    n_unmatched_observations: int
    unmatched_rate: float
    unmatched_by_camera: dict[int, int]
    raw_errors: RawErrors
    n_observations_matched: int
    n_observations_total: int
    n_cameras: int
    n_points: int

    def summary(self) -> str:
        lines = [
            f"Reprojection RMSE: {self.overall_rmse:.3f} px over "
            f"{self.n_observations_matched} observations / {self.n_points} points / {self.n_cameras} cameras",
        ]
        for cid in sorted(self.by_camera):
            lines.append(f"  cam {cid}: {self.by_camera[cid]:.3f} px")
        if self.n_unmatched_observations:
            lines.append(f"  unmatched observations: {self.n_unmatched_observations} ({self.unmatched_rate:.1%})")
        return "\n".join(lines)
