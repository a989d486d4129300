"""Ground-truth scene: objects x trajectories x cameras -> observations.

Port of caliscope_tpu/synthetic/scene.py: world points, perfect and noisy
(seeded Gaussian pixel noise) image points, the coverage matrix.

Image formation uses the port's own projection (CameraData.project_points,
float64 on the host) — the same function the solvers invert — so every
solver test is an exact round trip; the JAX package projects through its
own, so the two engines' img_xy agree to float64 roundoff while integer
columns, visibility and noise are equal. Visibility = point in front of
the camera AND inside the frame bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
from caliscope_tpu_torch.synthetic.calibration_object import CalibrationObject
from caliscope_tpu_torch.synthetic.trajectory import Trajectory


@dataclass
class SyntheticScene:
    cameras: CameraArray
    objects: list[CalibrationObject]
    trajectories: list[Trajectory]
    noise_sigma_px: float = 0.5
    seed: int = 42
    margin_px: float = 5.0
    # When True, planar objects are one-sided: a point is visible only when
    # the object's local +z normal faces the camera (realistic for printed
    # boards; grazing angles beyond ~80 deg are also culled).
    cull_backfaces: bool = False

    def __post_init__(self):
        if len(self.objects) != len(self.trajectories):
            raise ValueError("One trajectory per object required")
        self._n_frames = len(self.trajectories[0]) if self.trajectories else 0
        for t in self.trajectories:
            if len(t) != self._n_frames:
                raise ValueError("All trajectories must have the same length")

    @property
    def n_frames(self) -> int:
        return self._n_frames

    def world_points(self) -> WorldPoints:
        """Exact ground-truth 3D keypoints per sync index (static objects
        collapse to STATIC_SYNC_INDEX like the triangulation output)."""
        from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX

        sync, obj, kp, xyz = [], [], [], []
        for o, traj in zip(self.objects, self.trajectories):
            if o.static:
                pts = traj[0].apply(o.points_local)
                for k in range(o.n_keypoints):
                    sync.append(STATIC_SYNC_INDEX)
                    obj.append(o.object_id)
                    kp.append(k)
                    xyz.append(pts[k])
            else:
                for s in range(self.n_frames):
                    pts = traj[s].apply(o.points_local)
                    for k in range(o.n_keypoints):
                        sync.append(s)
                        obj.append(o.object_id)
                        kp.append(k)
                        xyz.append(pts[k])
        return WorldPoints(np.array(sync), np.array(obj), np.array(kp), np.array(xyz))

    def _observations(self) -> ImagePoints:
        rows_sync, rows_cam, rows_obj, rows_kp = [], [], [], []
        rows_xy, rows_ol = [], []
        for o, traj in zip(self.objects, self.trajectories):
            for s in range(self.n_frames):
                Xw = traj[s].apply(o.points_local)
                for cid in sorted(self.cameras.active_cameras):
                    cam = self.cameras.cameras[int(cid)]
                    # depth check in camera frame
                    Xc = (cam.rotation @ Xw.T).T + cam.translation
                    in_front = Xc[:, 2] > 0.05
                    uv = cam.project_points(Xw)
                    w, h = cam.size
                    m = self.margin_px
                    in_frame = (
                        (uv[:, 0] >= m) & (uv[:, 0] <= w - m) & (uv[:, 1] >= m) & (uv[:, 1] <= h - m)
                    )
                    vis = in_front & in_frame
                    if self.cull_backfaces:
                        normal_w = traj[s].rotation @ np.asarray(o.normal_local, dtype=np.float64)
                        cam_center = -cam.rotation.T @ cam.translation
                        to_cam = cam_center - Xw
                        cosang = (to_cam @ normal_w) / np.maximum(np.linalg.norm(to_cam, axis=1), 1e-9)
                        vis &= cosang > np.cos(np.deg2rad(80.0))
                    for k in np.where(vis)[0]:
                        rows_sync.append(s)
                        rows_cam.append(int(cid))
                        rows_obj.append(o.object_id)
                        rows_kp.append(int(k))
                        rows_xy.append(uv[k])
                        rows_ol.append(o.points_local[k])
        if not rows_sync:
            return ImagePoints.empty()
        return ImagePoints(
            np.array(rows_sync),
            np.array(rows_cam),
            np.array(rows_obj),
            np.array(rows_kp),
            np.array(rows_xy),
            np.array(rows_ol),
        )

    def image_points_perfect(self) -> ImagePoints:
        return self._observations()

    def image_points_noisy(self, sigma_px: float | None = None, seed: int | None = None) -> ImagePoints:
        ip = self._observations()
        sigma = self.noise_sigma_px if sigma_px is None else sigma_px
        rng = np.random.default_rng(self.seed if seed is None else seed)
        noisy = ip.img_xy + rng.normal(scale=sigma, size=ip.img_xy.shape)
        return ImagePoints(ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id, noisy, ip.obj_loc, ip.frame_time)

    def coverage_matrix(self, image_points: ImagePoints | None = None) -> np.ndarray:
        """(C,C) count of shared (sync, obj, kp) observations per camera pair."""
        ip = image_points if image_points is not None else self._observations()
        ids = sorted(self.cameras.active_cameras.keys())
        idx = {cid: i for i, cid in enumerate(ids)}
        C = len(ids)
        cov = np.zeros((C, C), dtype=np.int64)
        pt_idx, _ = ip.point_index()
        cam_idx = np.array([idx[int(c)] for c in ip.cam_id])
        for p in range(pt_idx.max() + 1 if len(pt_idx) else 0):
            cams = np.unique(cam_idx[pt_idx == p])
            for a in cams:
                for b in cams:
                    cov[a, b] += 1
        return cov

    def static_object_ids(self) -> frozenset[int]:
        return frozenset(o.object_id for o in self.objects if o.static)
