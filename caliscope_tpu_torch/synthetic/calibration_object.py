"""Rigid calibration objects with exactly known local geometry.

Port of caliscope_tpu/synthetic/calibration_object.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CalibrationObject:
    """Keypoints in the object's local frame, keyed by keypoint_id order.

    normal_local is the printed face's outward normal in local coordinates,
    used only when the scene culls backfaces. Defaults to +z; a two-sided
    board is two objects on one trajectory with opposite normals (front face
    -z, back face +z, matching Charuco.object_corners' board frame where z
    points through the substrate toward the back).
    """

    object_id: int
    points_local: np.ndarray  # (K,3)
    static: bool = False
    normal_local: tuple[float, float, float] = (0.0, 0.0, 1.0)

    def __post_init__(self):
        object.__setattr__(self, "points_local", np.asarray(self.points_local, dtype=np.float64).reshape(-1, 3))

    @property
    def n_keypoints(self) -> int:
        return len(self.points_local)

    @classmethod
    def planar_grid(
        cls,
        object_id: int = 0,
        rows: int = 4,
        cols: int = 6,
        spacing: float = 0.05,
        static: bool = False,
    ) -> "CalibrationObject":
        """rows x cols grid of inner corners in the z=0 plane, centered at the
        origin — the geometry of a charuco/chessboard corner lattice."""
        jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
        pts = np.stack(
            [
                (jj.ravel() - (cols - 1) / 2) * spacing,
                (ii.ravel() - (rows - 1) / 2) * spacing,
                np.zeros(rows * cols),
            ],
            axis=1,
        )
        return cls(object_id, pts, static)

    @classmethod
    def from_points(cls, object_id: int, points: np.ndarray, static: bool = False) -> "CalibrationObject":
        return cls(object_id, np.asarray(points, dtype=np.float64), static)

    def pairwise_distances(self) -> np.ndarray:
        d = self.points_local[:, None, :] - self.points_local[None, :, :]
        return np.linalg.norm(d, axis=-1)
