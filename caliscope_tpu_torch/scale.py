"""Metric scale cues + scale-accuracy QA + world-frame basis helper.

Parity: reference src/caliscope/core/scale_cues.py (CameraDistance:16,
SegmentLength:26, DepthObservation:36), core/scale_accuracy.py
(FrameScaleError:22, VolumetricScaleReport:45, compute_depth_ratios:210,
compute_frame_scale_error:237), core/coordinate_frame.py
(world_basis_from_up_and_forward:14).

Host-only copy of caliscope_tpu/scale.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX


# ---------------------------------------------------------------------------
# Scale cues
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CameraDistance:
    """Known metric distance between two camera centers."""

    cam_a: int
    cam_b: int
    meters: float
    sigma_m: float = 0.01


@dataclass(frozen=True)
class SegmentLength:
    """Known metric length between two tracked keypoints (e.g. a wand)."""

    keypoint_id_a: int
    keypoint_id_b: int
    meters: float
    sigma_m: float = 0.005


@dataclass(frozen=True)
class DepthObservation:
    """Estimator-supplied metric depth of a keypoint from a camera (bulk cue)."""

    cam_id: int
    sync_index: int
    keypoint_id: int
    depth_m: float
    sigma_m: float = 0.05


# ---------------------------------------------------------------------------
# Scale-accuracy QA vs target ground truth
# ---------------------------------------------------------------------------


def _pdist(X: np.ndarray) -> np.ndarray:
    """All pairwise distances of (N,3) points — vectorized, no scipy."""
    d = X[:, None, :] - X[None, :, :]
    iu = np.triu_indices(len(X), k=1)
    return np.sqrt(np.sum(d[iu] ** 2, axis=-1))


@dataclass(frozen=True)
class FrameScaleError:
    """Per-(frame, object) scale accuracy: triangulated vs known pairwise
    distances. Positive signed error = reconstruction too large."""

    sync_index: int
    object_id: int
    distance_rmse_mm: float
    distance_mean_signed_error_mm: float
    distance_max_error_mm: float
    n_corners: int
    n_distance_pairs: int
    n_cameras_contributing: int
    sum_squared_errors_m2: float
    sum_squared_relative_errors: float
    centroid: tuple[float, float, float]


@dataclass(frozen=True)
class VolumetricScaleReport:
    frame_errors: tuple[FrameScaleError, ...]
    static_object_ids: frozenset[int] = frozenset()

    @classmethod
    def empty(cls) -> "VolumetricScaleReport":
        return cls(frame_errors=())

    @cached_property
    def pooled_rmse_mm(self) -> float:
        total_sse = sum(fe.sum_squared_errors_m2 for fe in self.frame_errors)
        total_pairs = sum(fe.n_distance_pairs for fe in self.frame_errors)
        return float(np.sqrt(total_sse / total_pairs) * 1000) if total_pairs else 0.0

    @cached_property
    def median_rmse_mm(self) -> float:
        return float(np.median([fe.distance_rmse_mm for fe in self.frame_errors])) if self.frame_errors else 0.0

    @cached_property
    def max_rmse_mm(self) -> float:
        return float(max(fe.distance_rmse_mm for fe in self.frame_errors)) if self.frame_errors else 0.0

    @cached_property
    def worst_frame(self) -> FrameScaleError | None:
        return max(self.frame_errors, key=lambda fe: fe.distance_rmse_mm) if self.frame_errors else None

    @cached_property
    def n_frames_sampled(self) -> int:
        return len(self.frame_errors)

    @cached_property
    def mean_signed_error_mm(self) -> float:
        """Global bias indicator, weighted by pair count per frame."""
        total_pairs = sum(fe.n_distance_pairs for fe in self.frame_errors)
        if not total_pairs:
            return 0.0
        weighted = sum(fe.distance_mean_signed_error_mm * fe.n_distance_pairs for fe in self.frame_errors)
        return float(weighted / total_pairs)


def compute_frame_scale_error(
    world_points: np.ndarray,
    object_points: np.ndarray,
    sync_index: int,
    object_id: int,
    n_cameras_contributing: int,
) -> FrameScaleError:
    """Compare ALL pairwise triangulated distances to the object's known
    geometry at one frame (reference scale_accuracy.py:237-307)."""
    world_points = np.asarray(world_points, dtype=np.float64)
    object_points = np.asarray(object_points, dtype=np.float64)
    if world_points.shape != object_points.shape:
        raise ValueError(f"Shape mismatch: {world_points.shape} vs {object_points.shape}")
    if len(world_points) < 2:
        raise ValueError(f"Need at least 2 points to compute distances, got {len(world_points)}")
    measured = _pdist(world_points)
    true = _pdist(object_points)
    err = measured - true
    sse = float(np.sum(err**2))
    d_ref = float(np.max(true))
    centroid = tuple(float(v) for v in world_points.mean(axis=0))
    return FrameScaleError(
        sync_index=sync_index,
        object_id=object_id,
        distance_rmse_mm=float(np.sqrt(np.mean(err**2))) * 1000,
        distance_mean_signed_error_mm=float(np.mean(err)) * 1000,
        distance_max_error_mm=float(np.max(np.abs(err))) * 1000,
        n_corners=len(world_points),
        n_distance_pairs=len(err),
        n_cameras_contributing=n_cameras_contributing,
        sum_squared_errors_m2=sse,
        sum_squared_relative_errors=sse / d_ref**2 if d_ref > 0 else 0.0,
        centroid=centroid,  # type: ignore[arg-type]
    )


def compute_depth_ratios(camera_array, world_points) -> dict[int, float]:
    """Per posed camera: p95(z)/p5(z) of moving world points in that camera's
    frame — the intrinsic-refinement gate input (reference
    scale_accuracy.py:210-234). NaN when < 2 positive depths."""
    moving = world_points.select(world_points.sync_index != STATIC_SYNC_INDEX)
    posed = camera_array.posed_cameras
    if len(moving) == 0:
        return {cid: float("nan") for cid in posed}
    pts = moving.xyz
    ratios: dict[int, float] = {}
    for cid, cam in posed.items():
        z = (cam.rotation @ pts.T).T[:, 2] + cam.translation[2]
        z = z[z > 0]
        ratios[cid] = float(np.percentile(z, 95) / np.percentile(z, 5)) if len(z) >= 2 else float("nan")
    return ratios


# ---------------------------------------------------------------------------
# World basis from gravity-up + forward yaw anchor
# ---------------------------------------------------------------------------


def world_basis_from_up_and_forward(up: np.ndarray, forward: np.ndarray) -> np.ndarray:
    """Rotation R mapping current world coords into a frame where `up` -> +Z
    and the horizontal projection of `forward` -> +Y
    (reference core/coordinate_frame.py:14-35)."""
    up = np.asarray(up, dtype=np.float64)
    up = up / np.linalg.norm(up)
    fwd = np.asarray(forward, dtype=np.float64)
    horiz = fwd - np.dot(fwd, up) * up
    n = np.linalg.norm(horiz)
    if n < 1e-9:
        raise ValueError("forward is parallel to up; yaw is undefined")
    y_axis = horiz / n
    x_axis = np.cross(y_axis, up)
    # rows of R are the new basis vectors expressed in old coordinates
    return np.stack([x_axis, y_axis, up], axis=0)
