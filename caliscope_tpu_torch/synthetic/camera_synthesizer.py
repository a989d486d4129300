"""Fluent synthetic camera-rig builder with lens profiles.

Port of caliscope_tpu/synthetic/camera_synthesizer.py; it builds the
port's CameraArray.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.synthetic.se3 import SE3Pose


@dataclass(frozen=True)
class LensProfile:
    """Intrinsics template."""

    size: tuple[int, int] = (1920, 1080)
    focal: float = 1400.0
    distortions: tuple[float, ...] = (-0.21, 0.05, 0.0008, -0.0005, 0.01)
    fisheye: bool = False

    @classmethod
    def machine_vision(cls) -> "LensProfile":
        return cls(size=(1280, 1024), focal=1100.0, distortions=(-0.1, 0.02, 0.0, 0.0, 0.0))

    @classmethod
    def webcam(cls) -> "LensProfile":
        return cls(size=(1920, 1080), focal=1400.0, distortions=(-0.21, 0.05, 0.0008, -0.0005, 0.01))

    @classmethod
    def gopro_like_fisheye(cls) -> "LensProfile":
        return cls(size=(1920, 1440), focal=900.0, distortions=(0.05, -0.01, 0.004, -0.001), fisheye=True)

    def make_matrix(self) -> np.ndarray:
        w, h = self.size
        return np.array([[self.focal, 0.0, w / 2.0], [0.0, self.focal, h / 2.0], [0.0, 0.0, 1.0]])


class CameraSynthesizer:
    """Builds ground-truth camera rigs; yields a posed, calibrated CameraArray."""

    def __init__(self, lens: LensProfile | None = None):
        self.lens = lens or LensProfile.webcam()
        self._cameras: dict[int, CameraData] = {}

    def _add_camera(self, pose: SE3Pose, lens: LensProfile) -> None:
        cam_id = len(self._cameras)
        extr = pose.inverse()  # world->camera
        self._cameras[cam_id] = CameraData(
            cam_id=cam_id,
            size=lens.size,
            matrix=lens.make_matrix(),
            distortions=np.asarray(lens.distortions),
            rotation=extr.rotation,
            translation=extr.translation,
            fisheye=lens.fisheye,
        )

    def add_ring(
        self,
        n_cameras: int = 4,
        radius: float = 2.0,
        height: float = 0.8,
        target=(0.0, 0.0, 0.0),
        lens: LensProfile | None = None,
        start_angle: float = 0.0,
    ) -> "CameraSynthesizer":
        lens = lens or self.lens
        for i in range(n_cameras):
            angle = start_angle + 2 * np.pi * i / n_cameras
            pos = np.array([radius * np.cos(angle), radius * np.sin(angle), height])
            self._add_camera(SE3Pose.look_at(pos, target), lens)
        return self

    def add_line(
        self,
        n_cameras: int = 2,
        start=(-1.0, -2.0, 1.0),
        end=(1.0, -2.0, 1.0),
        target=(0.0, 0.0, 0.0),
        lens: LensProfile | None = None,
    ) -> "CameraSynthesizer":
        lens = lens or self.lens
        start = np.asarray(start, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        for i in range(n_cameras):
            frac = i / max(n_cameras - 1, 1)
            self._add_camera(SE3Pose.look_at(start + frac * (end - start), target), lens)
        return self

    def add_camera_at(self, position, target=(0.0, 0.0, 0.0), lens: LensProfile | None = None) -> "CameraSynthesizer":
        self._add_camera(SE3Pose.look_at(position, target), lens or self.lens)
        return self

    def build(self) -> CameraArray:
        return CameraArray({cid: c.copy() for cid, c in self._cameras.items()})


def perturb_intrinsics(cameras: CameraArray, rng: np.random.Generator, f_sigma: float = 0.05, k_sigma: float = 0.02) -> CameraArray:
    """Multiplicative focal noise + additive k1/k2 noise — fabricates the
    'roughly calibrated' premise for intrinsic-refinement scenarios."""
    out = cameras.copy()
    for cam in out.cameras.values():
        if cam.matrix is not None:
            scale = 1.0 + rng.normal(scale=f_sigma)
            cam.matrix = cam.matrix.copy()
            cam.matrix[0, 0] *= scale
            cam.matrix[1, 1] *= scale
        if cam.distortions is not None:
            cam.distortions = cam.distortions.copy()
            cam.distortions[:2] += rng.normal(scale=k_sigma, size=2)
    return out


def strip_intrinsics(cameras: CameraArray) -> CameraArray:
    out = cameras.copy()
    for cam in out.cameras.values():
        cam.matrix = None
        cam.distortions = None
        cam.error = None
    return out


def strip_extrinsics(cameras: CameraArray) -> CameraArray:
    out = cameras.copy()
    for cam in out.cameras.values():
        cam.rotation = None
        cam.translation = None
    return out
