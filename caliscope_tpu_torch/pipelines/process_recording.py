"""Streaming multicam processing: producer threads + ordered consumer.

Port of caliscope_tpu/pipelines/process_recording.py (host threads; the
tracker's chunks run on its device).

Parity: reference src/caliscope/core/process_synchronized_recording.py:39-269
— one decode+track producer thread per camera with bounded queues (depth 8)
for backpressure, a single consumer walking sync indices in order assembling
cross-camera FrameData for live display, CPU-core decode budget split across
cameras. This is the GUI-facing streaming variant; batch extraction without
display callbacks lives in api.extract_image_points_multicam.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from queue import Queue
from threading import Thread
from typing import Callable, Optional

import numpy as np

from caliscope_tpu_torch.cameras import CameraData
from caliscope_tpu_torch.media import FrameSource, SynchronizedTimestamps
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.packets import PointPacket
from caliscope_tpu_torch.tasks import CancellationToken
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)

QUEUE_DEPTH = 8


@dataclass
class FrameData:
    """Frame data for a single camera at a sync index."""

    frame: np.ndarray
    points: Optional[PointPacket]
    frame_index: int


def process_synchronized_recording(
    recording_dir: Path,
    cameras: dict[int, CameraData],
    tracker: Tracker,
    synced_timestamps: SynchronizedTimestamps,
    *,
    subsample: int = 1,
    on_progress: Optional[Callable[[int, int], None]] = None,
    on_frame_data: Optional[Callable[[int, dict[int, FrameData]], None]] = None,
    token: Optional[CancellationToken] = None,
) -> ImagePoints:
    """Extract 2D landmarks with live cross-camera frame assembly."""
    recording_dir = Path(recording_dir)
    all_sync = synced_timestamps.sync_indices[::subsample]
    total = len(all_sync)
    cam_ids = [c for c in synced_timestamps.cam_ids if (recording_dir / f"cam_{c}.mp4").exists()]
    logger.info(f"Processing {total} sync indices (subsample={subsample})")

    cam_work: dict[int, dict[int, int]] = {}
    for cid in cam_ids:
        mapping = {}
        for si in all_sync:
            fi = synced_timestamps.frame_for(si, cid)
            if fi is not None:
                mapping[fi] = si
        cam_work[cid] = mapping

    queues: dict[int, Queue] = {cid: Queue(maxsize=QUEUE_DEPTH) for cid in cam_ids}

    def worker(cid: int) -> None:
        frame_to_sync = cam_work[cid]
        q = queues[cid]
        src = FrameSource(
            recording_dir / f"cam_{cid}.mp4",
            cid,
            wanted_indices=set(frame_to_sync),
            pixel_format=tracker.pixel_format,
            # reference's per-stream decode budget (process_synchronized_recording.py:76)
            decode_threads=max(1, (os.cpu_count() or 4) // max(len(cam_ids), 1)),
            device=tracker.device,
        )
        cam = cameras.get(cid)
        rot = cam.rotation_count if cam is not None else 0
        from caliscope_tpu_torch.api import _iter_tracked_batched

        try:
            # chunk frames through the tracker's batched hook: one device
            # program per chunk for device-batched trackers (same rationale
            # as api._iter_tracked_batched). The queue bounds memory; the
            # consumer still sees strictly per-frame, sync-ordered items.
            def cancellable_frames():
                while True:
                    if token is not None and token.is_cancelled:
                        return
                    raw = src.next_frame()
                    if raw is None:
                        return
                    yield raw

            for raw, pts in _iter_tracked_batched(cancellable_frames(), tracker, cid, rot):
                si = frame_to_sync[raw.frame_index]
                q.put((si, FrameData(raw.frame, pts, raw.frame_index)))
        finally:
            src.close()
            q.put(None)

    threads = [Thread(target=worker, args=(cid,), daemon=True) for cid in cam_ids]
    for t in threads:
        t.start()

    rows: list[dict] = []
    buffers: dict[int, Optional[tuple]] = {cid: None for cid in cam_ids}
    done: set[int] = set()

    def pull(cid: int):
        if buffers[cid] is not None:
            return buffers[cid]
        item = queues[cid].get()
        if item is None:
            done.add(cid)
            return None
        buffers[cid] = item
        return item

    def accumulate(si: int, cid: int, fi: int, ft: float, pts: PointPacket) -> None:
        n = len(pts)
        if n == 0:
            return
        rows.append(
            {
                "sync_index": np.full(n, si, np.int64),
                "cam_id": np.full(n, cid, np.int64),
                "object_id": pts.object_id,
                "keypoint_id": pts.keypoint_id,
                "img_xy": pts.img_loc,
                "obj_loc": pts.obj_loc if pts.obj_loc is not None else np.full((n, 3), np.nan),
                "frame_time": np.full(n, ft),
            }
        )

    try:
        for i, si in enumerate(all_sync):
            if token is not None and token.is_cancelled:
                logger.info("Processing cancelled")
                break
            frame_data: dict[int, FrameData] = {}
            for cid in cam_ids:
                if cid in done:
                    continue
                item = pull(cid)
                if item is None:
                    continue
                item_sync, fd = item
                if item_sync == si:
                    frame_data[cid] = fd
                    ft = synced_timestamps.time_for(cid, fd.frame_index)
                    accumulate(si, cid, fd.frame_index, ft, fd.points)
                    buffers[cid] = None
            if on_frame_data is not None:
                on_frame_data(si, frame_data)
            if on_progress is not None:
                on_progress(i + 1, total)
    finally:
        for cid in cam_ids:
            if cid not in done:
                while True:
                    item = queues[cid].get()
                    if item is None:
                        break
        for t in threads:
            t.join(timeout=5)

    if not rows:
        return ImagePoints.empty()
    return ImagePoints(
        np.concatenate([r["sync_index"] for r in rows]),
        np.concatenate([r["cam_id"] for r in rows]),
        np.concatenate([r["object_id"] for r in rows]),
        np.concatenate([r["keypoint_id"] for r in rows]),
        np.concatenate([r["img_xy"] for r in rows]),
        np.concatenate([r["obj_loc"] for r in rows]),
        np.concatenate([r["frame_time"] for r in rows]),
    )
