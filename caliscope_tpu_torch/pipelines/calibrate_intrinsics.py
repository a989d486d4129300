"""Intrinsic-calibration use case: frame selection -> the port's solver.

Port of caliscope_tpu/pipelines/calibrate_intrinsics.py (reference
src/caliscope/core/calibrate_intrinsics.py: calibrate_intrinsics:89,
run_intrinsic_calibration:233, MIN_CORNERS_PER_FRAME:30,
IntrinsicCalibrationReport:54). Frame selection runs on the host;
solvers/intrinsics.solve_intrinsics (Zhang init + batched LM) runs on the
CUDA device unless the caller passes ``device="cpu"``. The results also carry
the solver's own record (`solve`: LM iterations, the restart, host reads),
which the JAX package's results do not.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from caliscope_tpu_torch.cameras import CameraData
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.frame_selector import select_calibration_frames
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.solvers.intrinsics import IntrinsicSolveResult, solve_intrinsics

logger = logging.getLogger(__name__)

# Divergence from the reference's MIN_CORNERS_PER_FRAME = 4 (reference
# calibrate_intrinsics.py:30): a 4-corner planar view fits its homography
# exactly, so it adds ~2 residual DOF of constraint while contributing a
# full nonconvex pose block whose bad init can wedge the joint LM (observed
# on real prerecorded_calibration cam_3: one 4-corner frame sent fx from
# ~660 to ~1170). cv2.calibrateCamera survives via per-view re-init; the
# batched solver instead requires frames that overdetermine the homography.
MIN_CORNERS_PER_FRAME = 6


@dataclass(frozen=True)
class IntrinsicCalibrationResult:
    camera_matrix: np.ndarray
    distortions: np.ndarray
    reprojection_error: float
    frames_used: int
    solve: IntrinsicSolveResult | None = field(default=None, compare=False)


@dataclass(frozen=True)
class IntrinsicCalibrationReport:
    rmse: float
    frames_used: int
    coverage_fraction: float
    edge_coverage_fraction: float
    corner_coverage_fraction: float
    orientation_sufficient: bool
    orientation_count: int
    selected_frames: tuple[int, ...]


@dataclass(frozen=True)
class IntrinsicCalibrationOutput:
    camera: CameraData
    report: IntrinsicCalibrationReport
    solve: IntrinsicSolveResult | None = field(default=None, compare=False)


def _pack_frames(image_points: ImagePoints, cam_id: int, selected_frames: list[int]):
    """Pad selected frames' (obj, img) correspondences to a fixed width."""
    sel = (image_points.cam_id == cam_id) & np.isin(image_points.sync_index, selected_frames)
    ip = image_points.select(sel)
    has_obj = np.isfinite(ip.obj_loc).all(axis=1)
    ip = ip.select(has_obj)
    frames = []
    for si in selected_frames:
        fsel = ip.sync_index == si
        if int(fsel.sum()) >= MIN_CORNERS_PER_FRAME:
            frames.append((ip.obj_loc[fsel], ip.img_xy[fsel]))
    if not frames:
        raise CalibrationError(
            f"No frames with >= {MIN_CORNERS_PER_FRAME} corners for camera {cam_id}; cannot calibrate intrinsics."
        )
    kmax = max(len(o) for o, _ in frames)
    F = len(frames)
    obj = np.zeros((F, kmax, 3))
    img = np.zeros((F, kmax, 2))
    mask = np.zeros((F, kmax), bool)
    for i, (o, u) in enumerate(frames):
        obj[i, : len(o)] = o
        img[i, : len(o)] = u
        mask[i, : len(o)] = True
    return obj, img, mask


def calibrate_intrinsics(
    image_points: ImagePoints,
    cam_id: int,
    image_size: tuple[int, int],
    selected_frames: list[int],
    *,
    fisheye: bool = False,
    f_scale_px: float | None = None,
    device=None,
    dtype=None,
) -> IntrinsicCalibrationResult:
    """Pure solve over the given frames (reference calibrate_intrinsics:89)."""
    obj, img, mask = _pack_frames(image_points, cam_id, selected_frames)
    result = solve_intrinsics(
        obj, img, mask, image_size, fisheye=fisheye, f_scale_px=f_scale_px, device=device, dtype=dtype
    )
    return IntrinsicCalibrationResult(
        camera_matrix=result.K,
        distortions=result.dist,
        reprojection_error=result.rmse,
        frames_used=result.n_frames,
        solve=result,
    )


def run_intrinsic_calibration(
    image_points: ImagePoints,
    camera: CameraData,
    *,
    target_frames: int = 30,
    fisheye: bool | None = None,
    f_scale_px: float | None = 1.0,
    device=None,
    dtype=None,
) -> IntrinsicCalibrationOutput:
    """Orchestrate: select frames -> solve -> camera + quality report
    (reference run_intrinsic_calibration:233).

    Divergence from the reference's cv2.calibrateCamera: the production path
    defaults to a soft_l1 robust loss at 1 px (f_scale_px) because the
    tracker commits full-board corner sets (including corners far from any
    detected marker), which extend distortion coverage but carry a heavier
    outlier tail than cv2's marker-adjacent-only interpolation. Pass
    f_scale_px=None for the plain quadratic loss. The solve runs on `device`
    (CUDA unless given) in `dtype` (float64 unless given, on CUDA too:
    solvers/intrinsics.py says why).
    """
    fe = camera.fisheye if fisheye is None else fisheye
    selected, coverage = select_calibration_frames(image_points, camera.cam_id, camera.size, target_frames)
    if not selected:
        raise CalibrationError(
            f"No usable calibration frames for camera {camera.cam_id}; check detection quality and target visibility."
        )
    result = calibrate_intrinsics(
        image_points,
        camera.cam_id,
        camera.size,
        selected,
        fisheye=fe,
        f_scale_px=f_scale_px,
        device=device,
        dtype=dtype,
    )
    new_camera = camera.copy()
    new_camera.matrix = result.camera_matrix
    new_camera.distortions = result.distortions
    new_camera.error = result.reprojection_error
    new_camera.grid_count = result.frames_used
    new_camera.fisheye = fe
    report = IntrinsicCalibrationReport(
        rmse=result.reprojection_error,
        frames_used=result.frames_used,
        coverage_fraction=coverage.coverage_fraction,
        edge_coverage_fraction=coverage.edge_coverage_fraction,
        corner_coverage_fraction=coverage.corner_coverage_fraction,
        orientation_sufficient=coverage.orientation_sufficient,
        orientation_count=coverage.orientation_count,
        selected_frames=coverage.selected_frames,
    )
    return IntrinsicCalibrationOutput(camera=new_camera, report=report, solve=result.solve)
