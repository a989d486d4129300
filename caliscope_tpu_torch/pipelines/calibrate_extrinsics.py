"""Production extrinsic-calibration pipeline.

Port of caliscope_tpu/pipelines/calibrate_extrinsics.py: the same ordered
gates and solve schedule — placeholder intrinsics for blind cameras, a
refusal to run the markerless (epipolar) bootstrap on placeholder
intrinsics, two-sided identity checks and mirror remaps, the pose-network
bootstrap, the cross-face coupling check for thick boards, the exclusion of
static markers that moved (with a rebuilt network), then linear BA ->
depth-ratio gate -> robust (soft-L1, 1 px) BA -> percentile outlier filter
-> final BA, every solve with the constraint set's rows. The run is a list
of `_Stage`s walked by a small loop that owns progress emission and
cancellation.

Devices: the bootstrap and every solve run on `device` (CUDA unless the
caller passes another, e.g. "cpu"); the solves in `dtype` (float32 on CUDA,
float64 on the CPU unless given), the pose network in the device's default.
Observations without obj_loc (markerless data) take the epipolar bootstrap
(solvers/epipolar.py) and then the same BA stages.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.constraints import ConstraintSet
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.scale import compute_depth_ratios
from caliscope_tpu_torch.tasks import CancellationToken
from caliscope_tpu_torch.tracing import span
from caliscope_tpu_torch.volume import CaptureVolume

logger = logging.getLogger(__name__)

# When every world point a camera sees sits in a narrow depth band, focal
# length and camera-to-scene distance trade off almost perfectly; letting the
# optimizer touch f under that ambiguity injects scale error into the
# translations. Refinement therefore requires each camera's far/near depth
# quotient to clear this floor.
MIN_DEPTH_RATIO_FOR_INTRINSIC_REFINEMENT = 2.0

# A "static" marker whose triangulated geometry wobbles by more than this
# fraction of its own physical span is evidently not rigid/stationary in the
# capture and would poison the constraint system.
_STATIC_MARKER_WOBBLE_FRACTION = 0.25


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
    constraints: Optional[ConstraintSet]
    refine_requested: bool
    filter_percentile: float
    device: torch.device
    dtype: torch.dtype
    volume: Optional[CaptureVolume] = None
    blind_cam_ids: set[int] = field(default_factory=set)
    intrinsic_anchors: dict[int, tuple[float, float, float]] = field(default_factory=dict)
    removed_markers: list[int] = field(default_factory=list)
    refine_active: bool = False
    refine_was_vetoed: bool = False


@dataclass(frozen=True)
class _Stage:
    label: str
    done_pct: int  # progress percentage reported when this stage starts
    run: Callable[[_RunState], None]

    @property
    def span_name(self) -> str:
        """The stage's span: `calibrate.` and its label in snake case."""
        return "calibrate." + self.label.lower().replace(" ", "_")


def _drive(stages: list[_Stage], state: _RunState, progress, token) -> None:
    """Walk the stage list: emit progress at entry, honour cancellation
    between stages, run each stage against the shared state (a span each,
    under the job's)."""
    with span("calibrate.job"):
        for stage in stages:
            if token is not None and token.is_cancelled:
                raise InterruptedError("Calibration cancelled")
            if progress is not None:
                progress(stage.done_pct, stage.label)
            with span(stage.span_name):
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
    if state.constraints is not None:
        thickness = state.constraints.back_face_thickness_m
        if thickness is not None:
            _guard_extraction_matches_thickness(state.points, thickness)
        # Fold zero-thickness mirror identities onto their front-face twins
        # now, so every later consumer (bootstrap, rebuilt networks, BA,
        # filtering, anything persisted) sees one consistent identity space.
        # Identity remap when the constraint set carries no folds.
        state.points = state.constraints.remap_image_points(state.points)


def _bootstrap(state: _RunState) -> CaptureVolume:
    return CaptureVolume.bootstrap(
        state.points, state.cameras, constraints=state.constraints, device=state.device, dtype=state.dtype
    )


def _stage_bootstrap(state: _RunState) -> None:
    state.volume = _bootstrap(state)
    if state.constraints is not None and (state.constraints.back_face_thickness_m or 0) > 0:
        _guard_faces_are_coupled(state.volume, state.constraints)


def _stage_static_marker_review(state: _RunState) -> None:
    """Exclude static markers that failed to hold still, then rebuild the
    pose network without them (their bogus geometry already leaked into it)."""
    if state.constraints is None or not state.constraints.static_object_ids:
        return
    offenders = _find_wobbling_static_markers(state.volume, state.constraints)
    if not offenders:
        return
    state.removed_markers = sorted(offenders)
    state.points = state.points.select(~np.isin(state.points.object_id, state.removed_markers))
    state.constraints = state.constraints.without_objects(frozenset(offenders))
    state.cameras = _cameras_with_placeholder_intrinsics(state.source_cameras, state.blind_cam_ids)
    state.volume = _bootstrap(state)


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
    constraints: Optional[ConstraintSet],
    *,
    refine_intrinsics: bool = True,
    filter_percentile: float = 2.5,
    cancellation_token: Optional[CancellationToken] = None,
    progress: Optional[Callable[[int, str], None]] = None,
    device=None,
    dtype=None,
) -> CalibrationRun:
    """Run the staged extrinsic pipeline (see module docstring) on `device`."""
    device = resolve_device(device)
    state = _RunState(
        points=image_points,
        source_cameras=camera_array,
        cameras=camera_array,  # replaced by the admit stage's working copy
        constraints=constraints,
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
        removed_markers=tuple(state.removed_markers),
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


def _guard_extraction_matches_thickness(points: ImagePoints, thickness_m: float) -> None:
    """The extraction froze a two-sided identity scheme into its rows; the
    constraint set compiles a fresh one from today's board config. If the
    thickness setting moved between the two, cross-face join keys stop
    matching and the mismatch shows up as silent mis-calibration, so detect
    the drift here and stop."""
    seen_ids = {int(o) for o in np.unique(points.object_id)}
    want_back_face = thickness_m > 0
    if 0 not in seen_ids:
        raise CalibrationError(
            f"The charuco extraction has no front-face rows (object_id 0; found "
            f"{sorted(seen_ids)}). Extract again with the current board configuration."
        )
    if want_back_face and 1 not in seen_ids:
        raise CalibrationError(
            "Board thickness is configured as nonzero, yet the extraction has no "
            "back-face rows (object_id 1). Either the footage was extracted before "
            "thickness was set (extract again), or no camera ever saw the mirrored "
            "face — in which case set thickness to 0 and calibrate single-sided."
        )
    if not want_back_face and 1 in seen_ids:
        raise CalibrationError(
            "The extraction contains back-face rows (object_id 1) but board thickness "
            "is configured as 0. Extract again under the current configuration, or "
            "restore the thickness value the extraction was made with."
        )
    if seen_ids - {0, 1}:
        raise CalibrationError(
            f"Unexpected object ids {sorted(seen_ids - {0, 1})} in a two-sided charuco "
            f"extraction (only 0=front, 1=back are valid). Extract again with the "
            f"current board configuration."
        )
    if want_back_face:
        back_rows = points.object_id == 1
        z_at_extraction = float(points.obj_loc[back_rows, 2][0])
        if abs(z_at_extraction - thickness_m) > 1e-9:
            raise CalibrationError(
                f"Thickness drift: the extraction placed the back face at "
                f"z = {z_at_extraction * 100:.2f} cm but the configuration now says "
                f"{thickness_m * 100:.2f} cm. Extract again, or restore the original "
                f"thickness setting."
            )


def _guard_faces_are_coupled(volume: CaptureVolume, constraints: ConstraintSet) -> None:
    """A thick board's two faces are rigidly tied only at sync indices where
    *both* faces triangulated (each needs two simultaneous cameras). If that
    never happens, the front-viewing and back-viewing camera groups share no
    rigid information and the solve would be determined by gauge freedom
    alone — refuse rather than return an arbitrary answer."""
    active = _count_active_cross_face_ties(volume, constraints)
    declared = sum(1 for d in constraints.distances if d.object_id_a != d.object_id_b)
    logger.info("Cross-face ties active in the data: %d of %d declared", active, declared)
    if active == 0:
        raise CalibrationError(
            "The front and back faces of the board were never triangulated at the "
            "same sync index (each face needs at least two cameras simultaneously), "
            "so none of the cross-face rigidity ties can act. The two camera groups "
            "are mechanically uncoupled and any relative placement would be "
            "arbitrary. Record footage where both faces are visible at the same "
            "moments, then re-extract."
        )


def _count_active_cross_face_ties(volume: CaptureVolume, constraints: ConstraintSet) -> int:
    """How many declared cross-face distance ties have both endpoints
    triangulated at at least one common sync index."""
    wp = volume.world_points
    sync_sets: dict[tuple[int, int], set[int]] = {}
    for s, o, k in zip(wp.sync_index, wp.object_id, wp.keypoint_id):
        sync_sets.setdefault((int(o), int(k)), set()).add(int(s))
    n_active = 0
    for tie in constraints.distances:
        if tie.object_id_a == tie.object_id_b:
            continue
        at_a = sync_sets.get((tie.object_id_a, tie.keypoint_id_a), set())
        at_b = sync_sets.get((tie.object_id_b, tie.keypoint_id_b), set())
        if at_a & at_b:
            n_active += 1
    return n_active


def _find_wobbling_static_markers(volume: CaptureVolume, constraints: ConstraintSet) -> list[int]:
    """Static markers whose within-marker rigidity error exceeds a quarter of
    their own physical span: evidence the marker moved (or is mis-declared
    static) during the capture."""
    report = volume.rigidity_report()
    span_by_object: dict[int, float] = {}
    for tie in constraints.distances:
        if tie.object_id_a == tie.object_id_b:
            oid = tie.object_id_a
            span_by_object[oid] = max(span_by_object.get(oid, 0.0), tie.distance)
    within = report.object_pairs[:, 0] == report.object_pairs[:, 1]
    offenders = []
    for oid in sorted(constraints.static_object_ids):
        span_mm = span_by_object.get(oid, 0.0) * 1000.0
        if span_mm <= 0:
            continue
        rows = within & (report.object_pairs[:, 0] == oid)
        if not rows.any():
            continue
        gap_mm = report.actual[rows] - report.expected[rows]
        wobble_mm = float(np.sqrt(np.mean(gap_mm**2))) * 1000.0
        if wobble_mm > _STATIC_MARKER_WOBBLE_FRACTION * span_mm:
            logger.warning(
                "Static marker %d moved during capture: rigidity error %.1f mm "
                "against a %.1f mm span (limit %.0f%%). Excluding it and "
                "rebuilding the pose network.",
                oid,
                wobble_mm,
                span_mm,
                100 * _STATIC_MARKER_WOBBLE_FRACTION,
            )
            offenders.append(oid)
    return offenders


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
