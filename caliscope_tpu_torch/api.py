"""Scripting API: the headless surface sharing the GUI's calibration core.

Port of caliscope_tpu/api.py (reference src/caliscope/api.py:
extract_image_points:134, extract_image_points_multicam:250 with one decode
thread per camera and a shared sync mapping, calibrate_intrinsics:436,
re-exports + auto progress).

Frames are read on the host (media/video.py) and go to the tracker in
chunks of CALISCOPE_EXTRACT_BATCH (16) frames through get_points_batch, so
a tracker on the card runs one device program per chunk; the tracker's
device is where detection runs. Two differences from the JAX package:
short final chunks are not padded (the JAX package repeats the last frame
so that XLA keeps one compiled shape; eager torch compiles nothing per
shape), and the multicamera rows come in the order of the `videos` mapping,
camera by camera, whichever thread finishes first (the JAX package appends
them as the threads finish).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

# Re-exported surface -------------------------------------------------------
from caliscope_tpu_torch.cameras import CameraArray, CameraData  # noqa: F401
from caliscope_tpu_torch.constraints import ConstraintSet  # noqa: F401
from caliscope_tpu_torch.exceptions import CalibrationError, CalibrationWarning  # noqa: F401
from caliscope_tpu_torch.export import write_blender_scene  # noqa: F401
from caliscope_tpu_torch.observations import ImagePoints, WorldPoints  # noqa: F401
from caliscope_tpu_torch.packets import PointPacket  # noqa: F401
from caliscope_tpu_torch.pipelines import CalibrationRun, calibrate_extrinsics  # noqa: F401
from caliscope_tpu_torch.pipelines.calibrate_intrinsics import (  # noqa: F401
    IntrinsicCalibrationOutput,
    IntrinsicCalibrationReport,
    run_intrinsic_calibration,
)
from caliscope_tpu_torch.estimators import VerticalEstimate, estimate_vertical  # noqa: F401
from caliscope_tpu_torch.scale import CameraDistance, DepthObservation, SegmentLength  # noqa: F401
from caliscope_tpu_torch.targets import ArucoMarkerSet, Charuco, Chessboard  # noqa: F401
from caliscope_tpu_torch.tracker import Tracker  # noqa: F401
from caliscope_tpu_torch.trackers import ArucoTracker, CharucoTracker, ChessboardTracker  # noqa: F401
from caliscope_tpu_torch.volume import CaptureVolume  # noqa: F401
from caliscope_tpu_torch.reporting import PlainProgress, ProgressCallback, RichProgressBar  # noqa: F401

__all__ = [
    "Charuco",
    "ArucoMarkerSet",
    "Chessboard",
    "Tracker",
    "CharucoTracker",
    "ArucoTracker",
    "ChessboardTracker",
    "ConstraintSet",
    "CameraData",
    "CameraArray",
    "ImagePoints",
    "WorldPoints",
    "CaptureVolume",
    "CameraDistance",
    "SegmentLength",
    "DepthObservation",
    "IntrinsicCalibrationOutput",
    "IntrinsicCalibrationReport",
    "CalibrationRun",
    "extract_image_points",
    "extract_image_points_multicam",
    "calibrate_intrinsics",
    "calibrate_extrinsics",
    "estimate_vertical",
    "VerticalEstimate",
    "write_blender_scene",
    "CalibrationError",
]

_AUTO = object()


class _NullProgress(PlainProgress):
    def on_info(self, m):
        pass

    def on_video_start(self, c, t):
        pass

    def on_frame(self, c, i, n):
        pass

    def on_video_complete(self, c):
        pass

    def on_stage(self, p, m):
        pass


def _auto_progress(progress):
    """Default to a Rich progress bar; None suppresses output."""
    if progress is _AUTO:
        return RichProgressBar()
    if progress is None:
        return _NullProgress()
    return progress


EXTRACT_BATCH = int(os.environ.get("CALISCOPE_EXTRACT_BATCH", 16))
_MAX_THREADS = 8  # reading and tracking threads of a multicam extraction, one a camera


def _iter_tracked_batched(src, tracker, cam_id: int, rotation_count: int, batch: int = EXTRACT_BATCH):
    """Yield (FramePacket, PointPacket) pulling `batch` frames at a time
    through tracker.get_points_batch: a device-batched tracker runs each
    chunk as one device program (per-frame get_points would pay a dispatch
    and a host round trip a frame). The last chunk is as short as the
    frames left."""
    buf = []

    def flush():
        pkts = tracker.get_points_batch(np.stack([r.frame for r in buf]), cam_id=cam_id, rotation_count=rotation_count)
        return list(zip(buf, pkts))

    for raw in src:
        buf.append(raw)
        if len(buf) >= batch:
            yield from flush()
            buf = []
    if buf:
        yield from flush()


def _packet_rows(sync_index, cam_id, frame_time, pkt) -> Optional[dict]:
    n = len(pkt.keypoint_id)
    if n == 0:
        return None
    obj_loc = pkt.obj_loc if pkt.obj_loc is not None else np.full((n, 3), np.nan)
    return {
        "sync_index": np.full(n, sync_index, np.int64),
        "cam_id": np.full(n, cam_id, np.int64),
        "object_id": pkt.object_id,
        "keypoint_id": pkt.keypoint_id,
        "img_xy": pkt.img_loc,
        "obj_loc": obj_loc,
        "frame_time": np.full(n, frame_time),
    }


def _rows_to_image_points(rows: list[dict]) -> ImagePoints:
    return ImagePoints(
        np.concatenate([r["sync_index"] for r in rows]),
        np.concatenate([r["cam_id"] for r in rows]),
        np.concatenate([r["object_id"] for r in rows]),
        np.concatenate([r["keypoint_id"] for r in rows]),
        np.concatenate([r["img_xy"] for r in rows]),
        np.concatenate([r["obj_loc"] for r in rows]),
        np.concatenate([r["frame_time"] for r in rows]),
    )


def extract_image_points(
    video_path: Path | str,
    cam_id: int,
    tracker: Tracker,
    *,
    frame_step: int = 1,
    rotation_count: int = 0,
    progress=_AUTO,
) -> ImagePoints:
    """Extract 2D landmark observations from a single camera video.

    frame_step processes every Nth frame (frame_step=5 typical for intrinsic
    calibration — only ~30 diverse frames are needed).
    """
    from caliscope_tpu_torch.media import FrameSource, read_video_properties

    if frame_step < 1:
        raise ValueError(f"frame_step of {frame_step} is invalid; it must be a positive stride")
    video_path = Path(video_path)
    if not video_path.exists():
        raise FileNotFoundError(f"no video file at {video_path}")

    with _auto_progress(progress) as prog:
        props = read_video_properties(video_path)
        wanted = set(range(0, props.frame_count, frame_step)) if frame_step > 1 else None
        total = (props.frame_count + frame_step - 1) // frame_step
        if frame_step > 1:
            prog.on_info(f"Sampling one of every {frame_step} frames ({total} of {props.frame_count})")
        prog.on_video_start(cam_id, total)

        rows: list[dict] = []
        with FrameSource(video_path, cam_id, wanted_indices=wanted, pixel_format=tracker.pixel_format,
                         device=tracker.device) as src:
            i = 0
            for raw, pkt in _iter_tracked_batched(src, tracker, cam_id, rotation_count):
                row = _packet_rows(raw.frame_index, cam_id, raw.frame_time, pkt)
                if row is not None:
                    rows.append(row)
                i += 1
                prog.on_frame(cam_id, i, len(pkt.keypoint_id))
        prog.on_video_complete(cam_id)

    if not rows:
        raise CalibrationError(
            "Tracker found zero landmarks across the whole video. Common causes: "
            "the calibration target never appears in frame, the tracker does not "
            "match the target type, or the video stream is unreadable."
        )
    return _rows_to_image_points(rows)


def extract_image_points_multicam(
    videos: Mapping[int, Path | str],
    tracker: Tracker,
    *,
    frame_step: int = 1,
    timestamps: Path | str | None = None,
    rotation_counts: Mapping[int, int] | None = None,
    progress=_AUTO,
) -> ImagePoints:
    """Synchronized multicam extraction: shared sync mapping, one reading
    and tracking thread per camera, up to 8. frame_step strides
    SYNC indices (not raw frames). The tracker must be thread-safe (the
    port's trackers are)."""
    from caliscope_tpu_torch.media import FrameSource, SynchronizedTimestamps

    if frame_step < 1:
        raise ValueError(f"frame_step of {frame_step} is invalid; it must be a positive stride")
    video_paths = {cid: Path(p) for cid, p in videos.items()}
    rotations = rotation_counts or {}
    missing = {cid: str(p) for cid, p in video_paths.items() if not p.exists()}
    if missing:
        detail = "\n".join(f"  cam {cid}: {p}" for cid, p in missing.items())
        raise FileNotFoundError(f"missing video files:\n{detail}")

    with _auto_progress(progress) as prog:
        if timestamps is not None:
            synced = SynchronizedTimestamps.from_csv_path(Path(timestamps))
        else:
            synced = SynchronizedTimestamps.from_video_paths(video_paths)
        selected = synced.sync_indices[::frame_step]
        if frame_step > 1:
            prog.on_info(
                f"Sampling one of every {frame_step} time-aligned frames "
                f"({len(selected)} of {len(synced.sync_indices)})"
            )

        def work_list(cam_id):
            out = []
            for si in selected:
                fi = synced.frame_for(si, cam_id)
                if fi is not None:
                    out.append((si, fi))
            return out

        def process(cam_id, work, path):
            sync_for = {fi: si for si, fi in work}
            rows = []
            prog.on_video_start(cam_id, len(work))
            with FrameSource(path, cam_id, wanted_indices=set(sync_for), pixel_format=tracker.pixel_format,
                             device=tracker.device) as src:
                processed = 0
                for raw, pkt in _iter_tracked_batched(src, tracker, cam_id, rotations.get(cam_id, 0)):
                    si = sync_for[raw.frame_index]
                    ft = synced.time_for(cam_id, raw.frame_index)
                    row = _packet_rows(si, cam_id, ft, pkt)
                    if row is not None:
                        rows.append(row)
                    processed += 1
                    prog.on_frame(cam_id, processed, len(pkt.keypoint_id))
            prog.on_video_complete(cam_id)
            return rows

        all_rows: list[dict] = []
        with ThreadPoolExecutor(max_workers=max(1, min(len(video_paths), _MAX_THREADS))) as pool:
            futures = [pool.submit(process, cid, work_list(cid), video_paths[cid]) for cid in video_paths]
            try:
                for fut in futures:
                    all_rows.extend(fut.result())
            except BaseException:
                for f in futures:
                    f.cancel()
                raise

    if not all_rows:
        raise CalibrationError(
            "Tracker found zero landmarks in every camera's video. Common causes: "
            "the calibration target never appears in any view, the tracker does "
            "not match the target type, or the video streams are unreadable."
        )
    return _rows_to_image_points(all_rows)


def calibrate_intrinsics(image_points: ImagePoints, camera: CameraData, device=None) -> IntrinsicCalibrationOutput:
    """Intrinsic calibration from 2D observations with known obj_loc, on
    `device` (CUDA unless named)."""
    if not image_points.any_obj_loc:
        raise CalibrationError(
            "Every obj_loc entry in these ImagePoints is NaN, so there is no known "
            "target geometry to calibrate against. Use a tracker with a physical "
            "target definition (CharucoTracker and friends); markerless body-pose "
            "trackers cannot drive intrinsic calibration."
        )
    try:
        return run_intrinsic_calibration(image_points, camera, device=device)
    except ValueError as e:
        raise CalibrationError(str(e)) from e
