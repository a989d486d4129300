"""Rigid-body trajectories for calibration objects.

Port of caliscope_tpu/synthetic/trajectory.py (orbital, linear,
stationary). A Trajectory is a list of SE3Poses (object local->world per
sync index).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from caliscope_tpu_torch.synthetic.se3 import SE3Pose


@dataclass(frozen=True)
class Trajectory:
    poses: tuple[SE3Pose, ...]

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, i: int) -> SE3Pose:
        return self.poses[i]

    @classmethod
    def orbital(
        cls,
        n_frames: int,
        radius: float = 0.5,
        center=(0.0, 0.0, 0.0),
        height_amplitude: float = 0.2,
        tilt_amplitude: float = 0.4,
        revolutions: float = 1.0,
    ) -> "Trajectory":
        """Object orbits the center, facing outward, with vertical bobbing and
        varying tilt — exercises diverse board orientations like a human
        waving a board through the volume."""
        center = np.asarray(center, dtype=np.float64)
        poses = []
        for i in range(n_frames):
            phase = 2 * np.pi * revolutions * i / max(n_frames - 1, 1)
            pos = center + np.array(
                [radius * np.cos(phase), radius * np.sin(phase), height_amplitude * np.sin(2 * phase)]
            )
            # face outward from center, tilt oscillates
            base = SE3Pose.look_at(pos, pos + (pos - center) + np.array([0, 0, 0.3]))
            tilted = base.with_pitch(tilt_amplitude * np.sin(3 * phase)).with_roll(0.5 * tilt_amplitude * np.cos(2 * phase))
            poses.append(tilted)
        return cls(tuple(poses))

    @classmethod
    def linear(
        cls,
        n_frames: int,
        start=(-0.5, 0.0, 0.0),
        end=(0.5, 0.0, 0.0),
        orientation: SE3Pose | None = None,
        tilt_amplitude: float = 0.3,
    ) -> "Trajectory":
        start = np.asarray(start, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        base_R = (orientation or SE3Pose.identity()).rotation
        poses = []
        for i in range(n_frames):
            frac = i / max(n_frames - 1, 1)
            pos = start + frac * (end - start)
            p = SE3Pose(base_R, pos).with_pitch(tilt_amplitude * np.sin(2 * np.pi * frac))
            poses.append(p)
        return cls(tuple(poses))

    @classmethod
    def stationary(cls, n_frames: int, pose: SE3Pose | None = None) -> "Trajectory":
        return cls(tuple([pose or SE3Pose.identity()] * n_frames))
