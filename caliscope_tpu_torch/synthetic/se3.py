"""Frozen SE(3) pose value type for scene construction.

Port of caliscope_tpu/synthetic/se3.py (numpy, with the numpy twins of
ops/lie.py). Convention: the pose maps local/body coords to world coords
(X_world = R @ X_local + t) — a camera pose's translation IS the camera
center. World->camera extrinsics are ``pose.inverse()``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from caliscope_tpu_torch.ops import lie


@dataclass(frozen=True)
class SE3Pose:
    rotation: np.ndarray  # (3,3) local->world
    translation: np.ndarray  # (3,) position in world

    def __post_init__(self):
        object.__setattr__(self, "rotation", np.asarray(self.rotation, dtype=np.float64).reshape(3, 3))
        object.__setattr__(self, "translation", np.asarray(self.translation, dtype=np.float64).reshape(3))

    @classmethod
    def identity(cls) -> "SE3Pose":
        return cls(np.eye(3), np.zeros(3))

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "SE3Pose":
        m = np.asarray(m)
        return cls(m[:3, :3], m[:3, 3])

    @classmethod
    def from_axis_angle(cls, axis, angle: float, translation=(0.0, 0.0, 0.0)) -> "SE3Pose":
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        R = lie.so3_exp_host(axis * angle)
        return cls(R, np.asarray(translation, dtype=np.float64))

    @classmethod
    def look_at(cls, position, target, up=(0.0, 0.0, 1.0)) -> "SE3Pose":
        """Camera-style pose at `position` with +z (optical axis) toward
        `target`, +y pointing 'down' consistent with image convention."""
        position = np.asarray(position, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        z = target - position
        z = z / np.linalg.norm(z)
        up = np.asarray(up, dtype=np.float64)
        x = np.cross(z, up)
        nx = np.linalg.norm(x)
        if nx < 1e-9:  # looking straight along up: pick arbitrary x
            x = np.cross(z, np.array([1.0, 0.0, 0.0]))
            nx = np.linalg.norm(x)
        x = x / nx
        y = np.cross(z, x)
        # columns of local->world rotation are the camera axes in world coords
        R = np.stack([x, y, z], axis=1)
        return cls(R, position)

    @property
    def matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m

    def compose(self, other: "SE3Pose") -> "SE3Pose":
        R = self.rotation @ other.rotation
        t = (self.rotation @ other.translation[..., None])[..., 0] + self.translation
        return SE3Pose(R, t)

    def inverse(self) -> "SE3Pose":
        return SE3Pose(*lie.se3_inverse_host(self.rotation, self.translation))

    def apply(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points, dtype=np.float64)
        return (self.rotation @ points.reshape(-1, 3).T).T.reshape(points.shape) + self.translation

    def with_roll(self, angle: float) -> "SE3Pose":
        """Rotate about the local z (optical) axis."""
        return self.compose(SE3Pose.from_axis_angle([0, 0, 1], angle))

    def with_pitch(self, angle: float) -> "SE3Pose":
        """Rotate about the local x axis."""
        return self.compose(SE3Pose.from_axis_angle([1, 0, 0], angle))

    @property
    def rvec(self) -> np.ndarray:
        return lie.so3_log_host(self.rotation)
