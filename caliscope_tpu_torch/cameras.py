"""Camera model + array-of-cameras container with device-tensor views.

Port of caliscope_tpu/cameras.py. The per-camera dataclasses stay host-side
numpy bookkeeping; `CameraArray.device_views()` stacks them into torch
tensors (K (C,3,3), dist (C,5), fisheye mask, rvec/tvec (C,3), projection
matrices (C,3,4)) on the requested device, keyed by a deterministic
cam_id -> index map. The TOML schema and writer are the JAX package's, so
files round-trip byte for byte between the two packages.

`CameraData.undistort_frame` applies its remap grid with
`torch.nn.functional.grid_sample` on the frame's device, where the JAX
package calls cv2.remap; `CameraArray.from_video_metadata` reads sizes
through the port's media layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from caliscope_tpu_torch import persistence
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.exceptions import CalibrationError, PersistenceError
from caliscope_tpu_torch.ops.lie import so3_exp_host, so3_log_host

MAX_DIST_COEFS = 5  # brown-conrady [k1,k2,p1,p2,k3]; fisheye uses first 4


def _np_or_none(v, shape=None):
    if v is None:
        return None
    a = np.asarray(v, dtype=np.float64)
    if shape is not None:
        a = a.reshape(shape)
    return a


def _host(fn, *arrays):
    """Run a tensor function on float64 CPU tensors made from host arrays."""
    return fn(*(torch.as_tensor(np.asarray(a, dtype=np.float64)) for a in arrays)).numpy()


@dataclass
class CameraData:
    """Single camera: intrinsics K/dist (+fisheye flag) and world->camera R,t
    (x_cam = R @ X + t; the normalized projection matrix is [R|t])."""

    cam_id: int
    size: tuple[int, int]
    rotation_count: int = 0
    error: Optional[float] = None
    matrix: Optional[np.ndarray] = None  # 3x3 K
    distortions: Optional[np.ndarray] = None  # (5,) brown or (4,) fisheye
    exposure: Optional[int] = None
    grid_count: Optional[int] = None
    ignore: bool = False
    translation: Optional[np.ndarray] = None  # (3,)
    rotation: Optional[np.ndarray] = None  # (3,3)
    fisheye: bool = False

    def __post_init__(self):
        self.matrix = _np_or_none(self.matrix, (3, 3)) if self.matrix is not None else None
        if self.distortions is not None:
            self.distortions = np.ravel(np.asarray(self.distortions, dtype=np.float64))
        self.translation = _np_or_none(self.translation, (3,)) if self.translation is not None else None
        if self.rotation is not None:
            r = np.asarray(self.rotation, dtype=np.float64)
            if r.shape in [(3,), (3, 1), (1, 3)]:
                # host Rodrigues, the JAX package's formula
                rv = np.ravel(r)
                theta = float(np.linalg.norm(rv))
                if theta < 1e-12:
                    r = np.eye(3)
                else:
                    k = rv / theta
                    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
                    r = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
            self.rotation = r.reshape(3, 3)

    @property
    def is_posed(self) -> bool:
        return self.rotation is not None and self.translation is not None

    @property
    def has_intrinsics(self) -> bool:
        return self.matrix is not None and self.distortions is not None

    @property
    def transformation(self) -> np.ndarray:
        assert self.rotation is not None and self.translation is not None
        m = np.eye(4)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m

    @transformation.setter
    def transformation(self, t: np.ndarray) -> None:
        t = np.asarray(t)
        self.rotation = t[:3, :3].copy()
        self.translation = t[:3, 3].copy()

    @property
    def normalized_projection_matrix(self) -> np.ndarray:
        return self.transformation[0:3, :]

    @property
    def rvec(self) -> np.ndarray:
        assert self.rotation is not None
        return so3_log_host(self.rotation)

    def extrinsics_to_vector(self) -> np.ndarray:
        return np.hstack([self.rvec, self.translation])

    def extrinsics_from_vector(self, row: np.ndarray) -> None:
        self.rotation = so3_exp_host(row[0:3])
        self.translation = np.asarray(row[3:6], dtype=np.float64)

    def undistort_points(self, points: np.ndarray, *, output: str = "normalized") -> np.ndarray:
        """Host (float64 CPU) undistortion of (N,2) pixel points."""
        from caliscope_tpu_torch.ops.projection import undistort_points

        if not self.has_intrinsics:
            raise CalibrationError(f"Camera {self.cam_id} lacks intrinsic calibration; cannot undistort points.")
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        return _host(
            lambda uv, K, d: undistort_points(uv, K, d, self.fisheye, output=output),
            pts, self.matrix, self.distortions,
        )

    def undistort_grid(self, height: int, width: int) -> np.ndarray:
        """(h, w, 2) float32 source pixel of each destination pixel: ideal
        normalized -> distorted -> pixels through this camera's model
        (reference camera_array.py:176-209, initUndistortRectifyMap),
        computed once per frame size in float64 on the host."""
        from caliscope_tpu_torch.ops.projection import distort_normalized, normalized_to_pixels, pixels_to_normalized

        grid = getattr(self, "_undistort_grid", None)
        if grid is None or grid.shape[:2] != (height, width):
            ys, xs = np.mgrid[0:height, 0:width]
            uv = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float64)
            src = _host(
                lambda p, K, d: normalized_to_pixels(distort_normalized(pixels_to_normalized(p, K), d, self.fisheye), K),
                uv, self.matrix, np.ravel(self.distortions),
            )
            grid = src.reshape(height, width, 2).astype(np.float32)
            self._undistort_grid = grid
        return grid

    def undistort_frame(self, frame, device=None):
        """Undistort a full uint8 frame ((h, w) or (h, w, 3)) through
        `undistort_grid`, bilinearly with a zero border, on the frame's
        device for a tensor (which comes back as a tensor) and on `device`
        (CUDA unless named) for a numpy array (which comes back as numpy).
        The JAX package applies the same grid with cv2.remap(INTER_LINEAR);
        the two part by at most one grey level (rounding of the weights and
        of grid_sample's normalized coordinates)."""
        if not self.has_intrinsics:
            raise CalibrationError(f"Camera {self.cam_id} lacks intrinsic calibration; cannot undistort frames.")
        as_numpy = not isinstance(frame, torch.Tensor)
        img = torch.from_numpy(np.ascontiguousarray(frame)).to(resolve_device(device)) if as_numpy else frame
        h, w = img.shape[:2]
        grid = torch.from_numpy(self.undistort_grid(h, w)).to(img.device)
        norm = torch.stack([grid[..., 0] * (2.0 / max(w - 1, 1)) - 1.0, grid[..., 1] * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
        planes = img.reshape(h, w, -1).permute(2, 0, 1)[None].to(torch.float32)
        out = torch.nn.functional.grid_sample(planes, norm[None], mode="bilinear", padding_mode="zeros", align_corners=True)
        out = torch.floor(out[0].permute(1, 2, 0) + 0.5).clamp(0, 255).to(torch.uint8).reshape(img.shape)
        return out.cpu().numpy() if as_numpy else out

    def project_points(self, X: np.ndarray) -> np.ndarray:
        """World points (N,3) -> pixels (N,2) through this camera (host)."""
        from caliscope_tpu_torch.ops.projection import project_points

        assert self.is_posed and self.has_intrinsics
        return _host(
            lambda x, r, t, K, d: project_points(x, r, t, K, d, self.fisheye),
            X, self.rvec, self.translation, self.matrix, self.distortions,
        )

    def erase_calibration_data(self) -> None:
        self.error = None
        self.matrix = None
        self.distortions = None
        self.grid_count = None
        self.translation = None
        self.rotation = None

    def synthesize_default_intrinsics(self) -> None:
        """Blind guess: f = width/2, principal point at center, zero distortion."""
        if self.size is None:
            raise CalibrationError(
                f"Camera {self.cam_id} has no resolution data. Load video metadata before synthesizing intrinsics."
            )
        if self.fisheye:
            raise CalibrationError(
                f"Camera {self.cam_id} is fisheye; blind intrinsics are not supported for the equidistant model. "
                f"Run intrinsic calibration for this camera."
            )
        w, h = self.size
        f = w / 2.0
        self.matrix = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
        self.distortions = np.zeros(5)

    def copy(self) -> "CameraData":
        return replace(
            self,
            matrix=None if self.matrix is None else self.matrix.copy(),
            distortions=None if self.distortions is None else self.distortions.copy(),
            rotation=None if self.rotation is None else self.rotation.copy(),
            translation=None if self.translation is None else self.translation.copy(),
        )


@dataclass
class DeviceViews:
    """Stacked per-camera tensors, ordered by cam index, on one device."""

    cam_ids: np.ndarray  # (C,) int, host
    K: torch.Tensor  # (C,3,3)
    dist: torch.Tensor  # (C,5) zero-padded
    fisheye: torch.Tensor  # (C,) bool
    rvec: torch.Tensor  # (C,3) (zeros when unposed)
    tvec: torch.Tensor  # (C,3)
    posed: torch.Tensor  # (C,) bool
    proj: torch.Tensor  # (C,3,4) normalized projection matrices [R|t]


@dataclass
class CameraArray:
    """Dictionary of cameras with deterministic ordering and TOML round trip."""

    cameras: dict[int, CameraData] = field(default_factory=dict)

    def __post_init__(self):
        self.cameras = dict(sorted(self.cameras.items()))

    # ---- views -------------------------------------------------------------
    @property
    def active_cameras(self) -> dict[int, CameraData]:
        return {cid: c for cid, c in self.cameras.items() if not c.ignore}

    @property
    def posed_cameras(self) -> dict[int, CameraData]:
        return {cid: c for cid, c in self.active_cameras.items() if c.is_posed}

    @property
    def cam_id_to_index(self) -> dict[int, int]:
        """Deterministic cam_id -> dense index over active cameras (sorted)."""
        return {cid: i for i, cid in enumerate(sorted(self.active_cameras.keys()))}

    @property
    def posed_cam_id_to_index(self) -> dict[int, int]:
        return {cid: i for i, cid in enumerate(sorted(self.posed_cameras.keys()))}

    @property
    def index_to_cam_id(self) -> dict[int, int]:
        return {i: cid for cid, i in self.cam_id_to_index.items()}

    @property
    def all_intrinsics_calibrated(self) -> bool:
        cams = self.active_cameras
        return len(cams) > 0 and all(c.has_intrinsics for c in cams.values())

    @property
    def all_extrinsics_calibrated(self) -> bool:
        cams = self.active_cameras
        return len(cams) > 0 and all(c.is_posed for c in cams.values())

    def projection_matrices(self) -> dict[int, np.ndarray]:
        return {cid: c.normalized_projection_matrix for cid, c in self.posed_cameras.items()}

    def device_views(self, posed_only: bool = False, device=None, dtype=None) -> DeviceViews:
        """Stacked camera tensors on `device` (CUDA unless named; float32
        there, float64 on the CPU unless `dtype` is given)."""
        device = resolve_device(device)
        dtype = resolve_dtype(device, dtype)
        cams = self.posed_cameras if posed_only else self.active_cameras
        ids = sorted(cams.keys())
        C = len(ids)
        K = np.zeros((C, 3, 3))
        dist = np.zeros((C, MAX_DIST_COEFS))
        fisheye = np.zeros(C, bool)
        rvec = np.zeros((C, 3))
        tvec = np.zeros((C, 3))
        posed = np.zeros(C, bool)
        proj = np.zeros((C, 3, 4))
        proj[:, :3, :3] = np.eye(3)
        for i, cid in enumerate(ids):
            c = cams[cid]
            K[i] = c.matrix if c.matrix is not None else np.eye(3)
            if c.distortions is not None:
                d = np.ravel(c.distortions)
                dist[i, : len(d)] = d[:MAX_DIST_COEFS]
            fisheye[i] = c.fisheye
            if c.is_posed:
                posed[i] = True
                rvec[i] = c.rvec
                tvec[i] = c.translation
                proj[i] = c.normalized_projection_matrix

        def t(a, dt=dtype):
            return torch.as_tensor(a, device=device, dtype=dt)

        return DeviceViews(
            np.array(ids), t(K), t(dist), t(fisheye, torch.bool), t(rvec), t(tvec),
            t(posed, torch.bool), t(proj),
        )

    # ---- mutation helpers --------------------------------------------------
    def copy(self) -> "CameraArray":
        return CameraArray({cid: c.copy() for cid, c in self.cameras.items()})

    def update_extrinsics(self, cam_id: int, rvec: np.ndarray, tvec: np.ndarray) -> None:
        cam = self.cameras[cam_id]
        cam.rotation = so3_exp_host(rvec)
        cam.translation = np.asarray(tvec, dtype=np.float64)

    @classmethod
    def from_video_metadata(cls, videos: dict[int, "Path | str"]) -> "CameraArray":
        """Uncalibrated cameras sized from video headers (reference
        docs/scripting.md step 2): {cam_id: video_path} -> CameraArray with
        resolution read from each file, no intrinsics/extrinsics yet."""
        from caliscope_tpu_torch.media import read_video_properties

        cams = {}
        for cid, path in videos.items():
            props = read_video_properties(Path(path))
            cams[int(cid)] = CameraData(cam_id=int(cid), size=props.size)
        return cls(cams)

    # ---- persistence -------------------------------------------------------
    @classmethod
    def from_toml(cls, path: Path | str) -> "CameraArray":
        """Load from caliscope-compatible camera_array.toml (rotation stored as
        3-vector rodrigues; 3x3 legacy matrices also accepted)."""
        data = persistence.load_toml(path)
        if not data or "cameras" not in data:
            return cls({})
        cameras: dict[int, CameraData] = {}
        for cam_id_str, cd in data["cameras"].items():
            try:
                # legacy serializer wrote missing optionals as the string "null"
                cd = {k: (None if v == "null" else v) for k, v in cd.items()}
                cam_id = int(cam_id_str)
                cameras[cam_id] = CameraData(
                    cam_id=cam_id,
                    size=(cd["size"][0], cd["size"][1]),
                    rotation_count=cd.get("rotation_count", 0),
                    error=cd.get("error"),
                    matrix=cd.get("matrix"),
                    distortions=cd.get("distortions"),
                    exposure=cd.get("exposure"),
                    grid_count=cd.get("grid_count"),
                    ignore=cd.get("ignore", False),
                    translation=cd.get("translation"),
                    rotation=cd.get("rotation"),
                    fisheye=cd.get("fisheye", False),
                )
            except (KeyError, ValueError, TypeError) as e:
                raise PersistenceError(f"Failed to parse camera {cam_id_str}: {e}") from e
        return cls(cameras)

    def to_toml(self, path: Path | str) -> None:
        cameras_data: dict[str, dict] = {}
        for cam_id, c in self.cameras.items():
            d = {
                "cam_id": c.cam_id,
                "size": list(c.size),
                "rotation_count": c.rotation_count,
                "error": c.error,
                "matrix": c.matrix.tolist() if c.matrix is not None else None,
                "distortions": c.distortions.tolist() if c.distortions is not None else None,
                "translation": c.translation.tolist() if c.translation is not None else None,
                "rotation": c.rvec.tolist() if c.rotation is not None else None,
                "exposure": c.exposure,
                "grid_count": c.grid_count,
                "fisheye": c.fisheye,
            }
            cameras_data[str(cam_id)] = {k: v for k, v in d.items() if v is not None}
        persistence.safe_write_toml({"cameras": cameras_data}, path)

    def to_aniposelib_toml(self, path: Path | str) -> None:
        """aniposelib-compatible export (posed cameras only), for
        Pose2Sim/anipose interop."""
        data: dict[str, dict] = {}
        for cam_id, c in self.posed_cameras.items():
            entry = {
                "name": f"cam_{cam_id}",
                "size": [int(c.size[0]), int(c.size[1])],
                "matrix": c.matrix.tolist() if c.matrix is not None else None,
                "distortions": c.distortions.ravel().tolist() if c.distortions is not None else None,
                "rotation": c.rvec.tolist(),
                "translation": c.translation.ravel().tolist(),
                "fisheye": c.fisheye,
            }
            data[f"cam_{cam_id}"] = {k: v for k, v in entry.items() if v is not None}
        data["metadata"] = {"adjusted": False, "error": 0.0}
        persistence.safe_write_toml(data, path)

    def __len__(self) -> int:
        return len(self.cameras)
