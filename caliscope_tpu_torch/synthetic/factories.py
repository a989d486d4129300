"""Canonical synthetic scenes used across the test suite.

Port of caliscope_tpu/synthetic/factories.py: default_ring_scene (a
4-camera ring r = 2 m, 5x7 grid board, 20-frame orbit) plus the
sparse-coverage / static-marker / two-sided / narrow-baseline /
depth-varied variants.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.synthetic.calibration_object import CalibrationObject
from caliscope_tpu_torch.synthetic.camera_synthesizer import CameraSynthesizer, LensProfile
from caliscope_tpu_torch.synthetic.scene import SyntheticScene
from caliscope_tpu_torch.synthetic.trajectory import Trajectory


def default_ring_scene(
    n_cameras: int = 4,
    n_frames: int = 20,
    noise_sigma_px: float = 0.5,
    rows: int = 5,
    cols: int = 7,
    square_size: float = 0.054,
    seed: int = 42,
) -> SyntheticScene:
    """4-camera ring (r=2 m) watching a 5x7 corner grid on a 20-frame orbit."""
    cameras = CameraSynthesizer(LensProfile.webcam()).add_ring(n_cameras, radius=2.0, height=0.8).build()
    board = CalibrationObject.planar_grid(object_id=0, rows=rows, cols=cols, spacing=square_size)
    traj = Trajectory.orbital(n_frames, radius=0.45, height_amplitude=0.25, tilt_amplitude=0.5)
    return SyntheticScene(cameras, [board], [traj], noise_sigma_px=noise_sigma_px, seed=seed)


def ring_with_static_markers(
    n_cameras: int = 4,
    n_frames: int = 20,
    n_static_markers: int = 3,
    marker_size: float = 0.1,
    noise_sigma_px: float = 0.5,
    seed: int = 42,
) -> SyntheticScene:
    """Ring scene plus static square markers fixed in the volume (exercises
    STATIC_SYNC_INDEX triangulation and static rigidity constraints)."""
    scene = default_ring_scene(n_cameras, n_frames, noise_sigma_px, seed=seed)
    objects = list(scene.objects)
    trajectories = list(scene.trajectories)
    rng = np.random.default_rng(seed + 1)
    half = marker_size / 2
    square = np.array([[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]])
    for m in range(n_static_markers):
        pos = rng.uniform([-0.6, -0.6, 0.2], [0.6, 0.6, 1.0])
        from caliscope_tpu_torch.synthetic.se3 import SE3Pose

        pose = SE3Pose.from_axis_angle(rng.normal(size=3), rng.uniform(0, np.pi / 4), pos)
        objects.append(CalibrationObject.from_points(object_id=100 + m, points=square, static=True))
        trajectories.append(Trajectory.stationary(n_frames, pose))
    return SyntheticScene(scene.cameras, objects, trajectories, noise_sigma_px=noise_sigma_px, seed=seed)


def two_sided_ring_scene(
    n_cameras: int = 6,
    n_frames: int = 24,
    noise_sigma_px: float = 0.5,
    rows: int = 5,
    columns: int = 7,
    square_size: float = 0.054,
    thickness_m: float = 0.006,
    seed: int = 42,
):
    """Ring of cameras around a TWO-SIDED charuco board on an orbital
    trajectory with backface culling: cameras on the board's printed-front
    side see object 0, cameras behind see the mirror face as object 1 at
    z=+thickness with the same keypoint ids (the identity scheme of
    the trackers). Exercises the full cross-face
    constraint linkage in calibrate_extrinsics.

    Returns (scene, charuco) so callers can build ConstraintSet.from_charuco.
    """
    from caliscope_tpu_torch.targets import Charuco

    ch = Charuco(rows=rows, columns=columns, square_size_m=square_size, thickness_m=thickness_m)
    front = ch.object_corners(0)
    back = ch.object_corners(1)
    # center the board's x/y footprint on the trajectory origin (z untouched:
    # obj_loc back-face z must stay exactly +thickness for identity checks)
    offset = np.array([front[:, 0].mean(), front[:, 1].mean(), 0.0])
    cameras = CameraSynthesizer(LensProfile.webcam()).add_ring(n_cameras, radius=2.0, height=0.8).build()
    obj_front = CalibrationObject(0, front - offset, normal_local=(0.0, 0.0, -1.0))
    obj_back = CalibrationObject(1, back - offset, normal_local=(0.0, 0.0, 1.0))
    traj = Trajectory.orbital(n_frames, radius=0.45, height_amplitude=0.25, tilt_amplitude=0.5)
    scene = SyntheticScene(
        cameras,
        [obj_front, obj_back],
        [traj, traj],
        noise_sigma_px=noise_sigma_px,
        seed=seed,
        cull_backfaces=True,
    )
    return scene, ch


def narrow_baseline_scene(n_frames: int = 20, separation_deg: float = 8.0, **kw) -> SyntheticScene:
    """Two nearly co-located cameras — ill-conditioned triangulation."""
    sep = np.deg2rad(separation_deg)
    cameras = (
        CameraSynthesizer(LensProfile.webcam())
        .add_camera_at([2.0 * np.cos(0), 2.0 * np.sin(0), 0.8])
        .add_camera_at([2.0 * np.cos(sep), 2.0 * np.sin(sep), 0.8])
        .build()
    )
    board = CalibrationObject.planar_grid(object_id=0, rows=5, cols=7, spacing=0.054)
    traj = Trajectory.orbital(n_frames, radius=0.4)
    return SyntheticScene(cameras, [board], [traj], **kw)


def depth_varied_scene(n_cameras: int = 4, n_frames: int = 24, **kw) -> SyntheticScene:
    """Board spirals from near the ring center out toward the cameras, giving
    every camera a near/far depth ratio > 2 — the regime where focal length is
    jointly observable with extrinsics (see calibrate_extrinsics' depth-ratio
    gate)."""
    from caliscope_tpu_torch.synthetic.se3 import SE3Pose

    cameras = CameraSynthesizer(LensProfile.webcam()).add_ring(n_cameras, radius=2.0, height=0.8).build()
    board = CalibrationObject.planar_grid(object_id=0, rows=5, cols=7, spacing=0.054)
    poses = []
    for i in range(n_frames):
        frac = i / max(n_frames - 1, 1)
        phase = 2 * np.pi * 2.0 * frac
        r = 0.15 + 1.25 * frac  # spiral outward
        pos = np.array([r * np.cos(phase), r * np.sin(phase), 0.8 + 0.25 * np.sin(3 * phase)])
        base = SE3Pose.look_at(pos, pos + pos + np.array([0, 0, 0.3]))
        poses.append(base.with_pitch(0.4 * np.sin(2 * phase)))
    from caliscope_tpu_torch.synthetic.trajectory import Trajectory as _T

    traj = _T(tuple(poses))
    return SyntheticScene(cameras, [board], [traj], **kw)


def sparse_coverage_scene(n_cameras: int = 6, n_frames: int = 30, **kw) -> SyntheticScene:
    """Chain-like coverage: the board orbits near the ring edge FACING
    OUTWARD with backface culling, so only the cameras ahead of its printed
    face see it at any instant — distant camera pairs share few or no
    observations, forcing transitive pose chaining."""
    cameras = CameraSynthesizer(LensProfile.webcam()).add_ring(n_cameras, radius=2.5, height=0.7).build()
    board = CalibrationObject.planar_grid(object_id=0, rows=4, cols=6, spacing=0.06)
    traj = Trajectory.orbital(n_frames, radius=1.1, height_amplitude=0.2, tilt_amplitude=0.4)
    return SyntheticScene(cameras, [board], [traj], cull_backfaces=True, **kw)
