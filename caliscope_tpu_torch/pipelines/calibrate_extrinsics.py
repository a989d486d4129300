"""Production extrinsic-calibration pipeline.

Port of caliscope_tpu/pipelines/calibrate_extrinsics.py: the same ordered
gates and solve schedule — placeholder intrinsics for blind cameras, a
refusal to run the markerless (epipolar) bootstrap on placeholder
intrinsics, the pose-network bootstrap, then linear BA -> depth-ratio gate
-> robust (soft-L1, 1 px) BA -> percentile outlier filter -> final BA. The
run is a list of `_Stage`s walked by a small driver that owns progress
emission and cancellation.

Devices: the bootstrap and every solve run on `device` (CUDA unless the
caller passes another, e.g. "cpu"); the solves in `dtype` (float32 on CUDA,
float64 on the CPU unless given), the pose network in the device's default.

Not ported yet: constraints (a non-None `constraints` raises
NotImplementedError before any work; with them go the two-sided identity
checks, mirror remaps, the cross-face coupling guard and the static-marker
review, ROADMAP.md queue 1 item 13), and the markerless bootstrap (item 22).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.scale import compute_depth_ratios
from caliscope_tpu_torch.solvers.bundle import not_ported
from caliscope_tpu_torch.tasks import CancellationToken
from caliscope_tpu_torch.volume import CaptureVolume

logger = logging.getLogger(__name__)

# When every world point a camera sees sits in a narrow depth band, focal
# length and camera-to-scene distance trade off almost perfectly; letting the
# optimizer touch f under that ambiguity injects scale error into the
# translations. Refinement therefore requires each camera's far/near depth
# quotient to clear this floor.
MIN_DEPTH_RATIO_FOR_INTRINSIC_REFINEMENT = 2.0


@dataclass(frozen=True)
class IntrinsicEstimate:
    """Free-intrinsics block for one camera: where refinement ended vs where
    it started."""

    cam_id: int
    f_recovered: float
    k1_recovered: float
    k2_recovered: float
    f_initial: float
    k1_initial: float
    k2_initial: float

    @property
    def f_change_pct(self) -> float:
        return 100.0 * (self.f_recovered - self.f_initial) / self.f_initial


@dataclass(frozen=True)
class CalibrationRun:
    capture_volume: CaptureVolume
    intrinsic_estimates: tuple[IntrinsicEstimate, ...]
    synthesized_cam_ids: frozenset[int]
    dropped_static_markers: tuple[int, ...]
    intrinsic_refinement_gated: bool


# ---------------------------------------------------------------------------
# Pipeline state + stage machinery
# ---------------------------------------------------------------------------


@dataclass
class _RunState:
    """Mutable working set handed from stage to stage."""

    points: ImagePoints
    source_cameras: CameraArray  # caller's array, never mutated
    cameras: CameraArray  # working copy
    refine_requested: bool
    filter_percentile: float
    device: torch.device
    dtype: torch.dtype
    volume: Optional[CaptureVolume] = None
    blind_cam_ids: set[int] = field(default_factory=set)
    intrinsic_anchors: dict[int, tuple[float, float, float]] = field(default_factory=dict)
    refine_active: bool = False
    refine_was_vetoed: bool = False


@dataclass(frozen=True)
class _Stage:
    label: str
    done_pct: int  # progress percentage reported when this stage starts
    run: Callable[[_RunState], None]


def _drive(stages: list[_Stage], state: _RunState, progress, token) -> None:
    """Walk the stage list: emit progress at entry, honour cancellation
    between stages, run each stage against the shared state."""
    for stage in stages:
        if token is not None and token.is_cancelled:
            raise InterruptedError("Calibration cancelled")
        if progress is not None:
            progress(stage.done_pct, stage.label)
        stage.run(state)
    if progress is not None:
        progress(100, "Optimization complete")


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _stage_admit(state: _RunState) -> None:
    state.cameras = _cameras_with_placeholder_intrinsics(state.source_cameras, state.blind_cam_ids)
    _guard_markerless_needs_real_intrinsics(state.points, state.blind_cam_ids)
    state.intrinsic_anchors = _record_intrinsic_anchors(state.cameras)


def _stage_bootstrap(state: _RunState) -> None:
    state.volume = CaptureVolume.bootstrap(state.points, state.cameras, device=state.device, dtype=state.dtype)


def _stage_static_marker_review(state: _RunState) -> None:
    """Static markers are declared by constraints, which this port does not
    take yet (calibrate_extrinsics refuses them): nothing to review."""


def _stage_linear_solve(state: _RunState) -> None:
    # First BA pass reaches the convergence basin on raw bootstrap geometry;
    # intrinsics stay frozen regardless of what the caller asked for.
    state.volume = state.volume.optimize(refine_intrinsics=False)


def _stage_gate_refinement(state: _RunState) -> None:
    ratios = compute_depth_ratios(state.volume.camera_array, state.volume.world_points)
    # NaN compares False against the floor, so a camera with degenerate depth
    # statistics vetoes refinement the same way a shallow one does.
    deep_enough = bool(ratios) and all(q >= MIN_DEPTH_RATIO_FOR_INTRINSIC_REFINEMENT for q in ratios.values())
    state.refine_active = state.refine_requested and deep_enough
    state.refine_was_vetoed = state.refine_requested and not state.refine_active
    if state.refine_was_vetoed:
        logger.warning(
            "Holding intrinsics fixed despite the refinement request: the depth "
            "spread is too shallow to separate focal length from camera distance "
            "(floor %.1f, per-camera far/near quotients %s).",
            MIN_DEPTH_RATIO_FOR_INTRINSIC_REFINEMENT,
            ratios,
        )


def _stage_robust_solve(state: _RunState) -> None:
    state.volume = state.volume.optimize(
        refine_intrinsics=state.refine_active,
        loss="soft_l1",
        f_scale=state.volume.pixel_f_scale(px=1.0),
        max_nfev=200,
        ftol=1e-4,
        strict=False,
    )


def _stage_filter(state: _RunState) -> None:
    state.volume = state.volume.filter_by_percentile_error(state.filter_percentile)


def _stage_final_solve(state: _RunState) -> None:
    state.volume = state.volume.optimize(refine_intrinsics=state.refine_active)


_STAGES = [
    _Stage("Preparing cameras", 5, _stage_admit),
    _Stage("Bootstrapping poses", 15, _stage_bootstrap),
    _Stage("Reviewing static markers", 25, _stage_static_marker_review),
    _Stage("Optimizing", 40, _stage_linear_solve),
    _Stage("Gating intrinsic refinement", 50, _stage_gate_refinement),
    _Stage("Robust refinement", 55, _stage_robust_solve),
    _Stage("Filtering outliers", 75, _stage_filter),
    _Stage("Re-optimizing", 90, _stage_final_solve),
]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def calibrate_extrinsics(
    image_points: ImagePoints,
    camera_array: CameraArray,
    constraints: None,
    *,
    refine_intrinsics: bool = True,
    filter_percentile: float = 2.5,
    cancellation_token: Optional[CancellationToken] = None,
    progress: Optional[Callable[[int, str], None]] = None,
    device=None,
    dtype=None,
) -> CalibrationRun:
    """Run the staged extrinsic pipeline (see module docstring) on `device`."""
    if constraints is not None:
        raise not_ported("calibrate_extrinsics with constraints", "item 13, constraints and constrained BA")
    device = resolve_device(device)
    state = _RunState(
        points=image_points,
        source_cameras=camera_array,
        cameras=camera_array,  # replaced by the admit stage's working copy
        refine_requested=refine_intrinsics,
        filter_percentile=filter_percentile,
        device=device,
        dtype=resolve_dtype(device, dtype),
    )
    _drive(_STAGES, state, progress, cancellation_token)
    return _assemble_run(
        volume=state.volume,
        anchors=state.intrinsic_anchors,
        blind_cam_ids=frozenset(state.blind_cam_ids),
        removed_markers=(),
        refine_was_vetoed=state.refine_was_vetoed,
    )


def refresh_run(previous: CalibrationRun, capture_volume: CaptureVolume) -> CalibrationRun:
    """Re-derive the run report around a re-optimized volume: provenance
    fields carry over, intrinsic estimates are recomputed against the
    original anchors."""
    anchors = {e.cam_id: (e.f_initial, e.k1_initial, e.k2_initial) for e in previous.intrinsic_estimates}
    return _assemble_run(
        volume=capture_volume,
        anchors=anchors,
        blind_cam_ids=previous.synthesized_cam_ids,
        removed_markers=previous.dropped_static_markers,
        refine_was_vetoed=previous.intrinsic_refinement_gated,
    )


# ---------------------------------------------------------------------------
# Guards and helpers
# ---------------------------------------------------------------------------


def _guard_markerless_needs_real_intrinsics(points: ImagePoints, blind_cam_ids: set[int]) -> None:
    """Markerless data routes through essential-matrix geometry, where a
    focal-length error masquerades as a pose error — PnP against known board
    geometry would absorb it, but there is no board here. Placeholder
    intrinsics would produce a rig that is wrong in *shape*, so refuse."""
    if points.any_obj_loc or not blind_cam_ids:
        return
    raise CalibrationError(
        f"This extraction carries no object geometry (obj_loc is empty), which sends "
        f"the bootstrap down the essential-matrix path — and cameras "
        f"{sorted(blind_cam_ids)} only have placeholder intrinsics (f = width/2). "
        f"Unlike PnP on a known board, epipolar geometry cannot absorb a focal-length "
        f"error, so the recovered camera network would be distorted rather than merely "
        f"mis-scaled. Calibrate intrinsics for those cameras (e.g. from charuco "
        f"footage) and rerun."
    )


def _cameras_with_placeholder_intrinsics(source: CameraArray, blind_out: set[int]) -> CameraArray:
    """Fresh working copy of the caller's array with f=width/2 placeholders
    filled in wherever intrinsics are absent; records which cameras needed
    them in ``blind_out``."""
    working = source.copy()
    for cam in working.cameras.values():
        if cam.ignore:
            continue
        if cam.matrix is None or cam.distortions is None:
            blind_out.add(cam.cam_id)
            cam.synthesize_default_intrinsics()
    return working


def _record_intrinsic_anchors(cameras: CameraArray) -> dict[int, tuple[float, float, float]]:
    """Snapshot (f, k1, k2) per calibrated camera before any solve touches
    them — the baseline that IntrinsicEstimate deltas are reported against."""
    return {
        cam.cam_id: (float(cam.matrix[0, 0]), float(cam.distortions[0]), float(cam.distortions[1]))
        for cam in cameras.cameras.values()
        if not cam.ignore and cam.matrix is not None and cam.distortions is not None
    }


def _assemble_run(
    volume: CaptureVolume,
    anchors: dict[int, tuple[float, float, float]],
    blind_cam_ids: frozenset[int],
    removed_markers: tuple[int, ...],
    refine_was_vetoed: bool,
) -> CalibrationRun:
    estimates = []
    for cam_id, cam in volume.camera_array.posed_cameras.items():
        anchor = anchors.get(cam_id)
        if anchor is None or cam.matrix is None or cam.distortions is None:
            continue
        estimates.append(
            IntrinsicEstimate(
                cam_id=cam_id,
                f_recovered=float(cam.matrix[0, 0]),
                k1_recovered=float(cam.distortions[0]),
                k2_recovered=float(cam.distortions[1]),
                f_initial=anchor[0],
                k1_initial=anchor[1],
                k2_initial=anchor[2],
            )
        )
    return CalibrationRun(
        capture_volume=volume,
        intrinsic_estimates=tuple(estimates),
        synthesized_cam_ids=blind_cam_ids,
        dropped_static_markers=removed_markers,
        intrinsic_refinement_gated=refine_was_vetoed,
    )
