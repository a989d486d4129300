"""Terminal progress + report rendering (port of caliscope_tpu/reporting.py, host code).

Parity: reference src/caliscope/reporting.py (ProgressCallback protocol :30,
thread-safe RichProgressBar:57, print_intrinsic_report:183,
print_extrinsic_report:243, print_camera_pair_coverage:325,
print_coverage_grid:404 with quality badges). Rich is optional — a plain
stream fallback keeps the scripting surface dependency-light.
"""

from __future__ import annotations

import sys
import threading
from typing import Protocol


class ProgressCallback(Protocol):
    def on_info(self, message: str) -> None: ...

    def on_video_start(self, cam_id: int, total_frames: int) -> None: ...

    def on_frame(self, cam_id: int, frame_index: int, n_points: int) -> None: ...

    def on_video_complete(self, cam_id: int) -> None: ...

    def on_stage(self, pct: int, message: str) -> None: ...


class PlainProgress:
    """Thread-safe line-based progress (stderr); the fallback when rich is
    unavailable or output is not a TTY."""

    def __init__(self, stream=None, every: int = 50):
        self._stream = stream or sys.stderr
        self._lock = threading.Lock()
        self._every = every
        self._totals: dict[int, int] = {}

    def on_info(self, message: str) -> None:
        with self._lock:
            print(message, file=self._stream)

    def on_video_start(self, cam_id: int, total_frames: int) -> None:
        with self._lock:
            self._totals[cam_id] = total_frames
            print(f"cam {cam_id}: extracting {total_frames} frames", file=self._stream)

    def on_frame(self, cam_id: int, frame_index: int, n_points: int) -> None:
        if frame_index % self._every:
            return
        with self._lock:
            total = self._totals.get(cam_id, 0)
            print(f"cam {cam_id}: {frame_index}/{total}", file=self._stream)

    def on_video_complete(self, cam_id: int) -> None:
        with self._lock:
            print(f"cam {cam_id}: done", file=self._stream)

    def on_stage(self, pct: int, message: str) -> None:
        with self._lock:
            print(f"[{pct:3d}%] {message}", file=self._stream)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class RichProgressBar(PlainProgress):
    """Rich-rendered multi-camera progress; degrades to PlainProgress."""

    def __init__(self):
        super().__init__()
        try:
            from rich.progress import BarColumn, Progress, TextColumn, TimeRemainingColumn

            self._progress = Progress(
                TextColumn("[progress.description]{task.description}"),
                BarColumn(),
                TextColumn("{task.completed}/{task.total}"),
                TimeRemainingColumn(),
            )
            self._tasks: dict[int, int] = {}
            self._rich = True
        except ImportError:
            self._rich = False

    def __enter__(self):
        if self._rich:
            self._progress.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rich:
            self._progress.__exit__(*exc)
        return False

    def on_info(self, message: str) -> None:
        if self._rich:
            with self._lock:
                self._progress.console.print(message)
        else:
            super().on_info(message)

    def on_video_start(self, cam_id: int, total_frames: int) -> None:
        if self._rich:
            with self._lock:
                self._tasks[cam_id] = self._progress.add_task(f"cam {cam_id}", total=total_frames)
        else:
            super().on_video_start(cam_id, total_frames)

    def on_frame(self, cam_id: int, frame_index: int, n_points: int) -> None:
        if self._rich:
            with self._lock:
                self._progress.update(self._tasks[cam_id], completed=frame_index)
        else:
            super().on_frame(cam_id, frame_index, n_points)

    def on_video_complete(self, cam_id: int) -> None:
        if self._rich:
            with self._lock:
                task = self._tasks.get(cam_id)
                if task is not None:
                    self._progress.update(task, completed=self._progress.tasks[task].total)
        else:
            super().on_video_complete(cam_id)

    def on_stage(self, pct: int, message: str) -> None:
        if self._rich:
            with self._lock:
                self._progress.console.print(f"[{pct:3d}%] {message}")
        else:
            super().on_stage(pct, message)


def _quality_badge(rmse: float) -> str:
    if rmse < 0.5:
        return "excellent"
    if rmse < 1.0:
        return "good"
    if rmse < 2.0:
        return "acceptable"
    return "poor"


def print_intrinsic_report(output, file=None) -> None:
    """Render an IntrinsicCalibrationOutput (reference reporting.py:183)."""
    file = file or sys.stdout
    r = output.report
    cam = output.camera
    print(f"Intrinsic calibration — camera {cam.cam_id}", file=file)
    print(f"  RMSE: {r.rmse:.3f} px ({_quality_badge(r.rmse)})", file=file)
    print(f"  frames used: {r.frames_used} (from {len(r.selected_frames)} selected)", file=file)
    print(
        f"  coverage: {r.coverage_fraction:.0%} grid, {r.edge_coverage_fraction:.0%} edges, "
        f"{r.corner_coverage_fraction:.0%} corners",
        file=file,
    )
    print(
        f"  orientation diversity: {r.orientation_count}/8 bins "
        f"({'sufficient' if r.orientation_sufficient else 'INSUFFICIENT — add tilted views'})",
        file=file,
    )
    if cam.matrix is not None:
        print(f"  f = ({cam.matrix[0, 0]:.1f}, {cam.matrix[1, 1]:.1f}) px, "
              f"c = ({cam.matrix[0, 2]:.1f}, {cam.matrix[1, 2]:.1f})", file=file)


def print_extrinsic_report(run, file=None) -> None:
    """Render a CalibrationRun (reference reporting.py:243)."""
    file = file or sys.stdout
    volume = run.capture_volume
    rep = volume.reprojection_report
    print("Extrinsic calibration", file=file)
    print(
        f"  overall RMSE: {rep.overall_rmse:.3f} px ({_quality_badge(rep.overall_rmse)}) over "
        f"{rep.n_observations_matched} observations / {rep.n_points} points",
        file=file,
    )
    for cid in sorted(rep.by_camera):
        print(f"    cam {cid}: {rep.by_camera[cid]:.3f} px", file=file)
    if run.synthesized_cam_ids:
        print(f"  blind intrinsics synthesized for cameras: {sorted(run.synthesized_cam_ids)}", file=file)
    if run.intrinsic_refinement_gated:
        print("  intrinsic refinement GATED OFF (insufficient depth variation)", file=file)
    for est in run.intrinsic_estimates:
        print(
            f"  cam {est.cam_id}: f {est.f_initial:.1f} -> {est.f_recovered:.1f} "
            f"({est.f_change_pct:+.1f}%), k1 {est.k1_initial:+.3f} -> {est.k1_recovered:+.3f}",
            file=file,
        )
    if run.dropped_static_markers:
        print(f"  dropped static markers: {list(run.dropped_static_markers)}", file=file)
    st = volume.optimization_status
    if st is not None:
        print(f"  solver: {st.termination_reason} in {st.iterations} iterations, cost {st.final_cost:.3e}", file=file)
        for w in st.bound_warnings:
            print(f"  WARNING: {w}", file=file)


def print_camera_pair_coverage(report, file=None) -> None:
    """Pairwise shared-observation table with quality badges
    (reference reporting.py:325)."""
    from caliscope_tpu_torch.coverage import classify_link_quality

    file = file or sys.stdout
    ids = report.cam_ids
    print("Camera-pair shared observations:", file=file)
    for i, a in enumerate(ids):
        for j, b in enumerate(ids):
            if j <= i:
                continue
            n = int(report.pairwise_observations[i, j])
            q = classify_link_quality(n).value
            print(f"  cam {a} <-> cam {b}: {n} ({q})", file=file)


def print_coverage_grid(report, file=None) -> None:
    """Matrix view of the coverage counts (reference reporting.py:404)."""
    from caliscope_tpu_torch.coverage import detect_structural_warnings

    file = file or sys.stdout
    ids = report.cam_ids
    width = max(6, max((len(str(int(v))) for v in report.pairwise_observations.ravel()), default=1) + 1)
    header = " " * 6 + "".join(f"{f'C{c}':>{width}}" for c in ids)
    print(header, file=file)
    for i, a in enumerate(ids):
        row = f"{f'C{a}':>6}" + "".join(
            f"{int(report.pairwise_observations[i, j]):>{width}}" for j in range(len(ids))
        )
        print(row, file=file)
    for w in detect_structural_warnings(report, len(ids)):
        print(f"  [{w.severity.value}] {w.message}", file=file)
