"""Temporal alignment across cameras: the greedy forward-pass sync algorithm.

Port of caliscope_tpu/media/synchronized_timestamps.py: the sync mapping is
the JAX package's, step for step; the CSV is read and written with the
standard library (persistence) where the JAX package uses pandas, in the
same bytes.

Parity: reference src/caliscope/recording/synchronized_timestamps.py:33-379 —
each camera's next frame is assigned to the current sync index or dropped
(None), decided by comparing its distance to the other cameras' earliest NEXT
frame vs latest CURRENT frame (:120-185). Factories from a timestamps CSV or
video metadata; frame_for/time_for queries; mean_fps.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from types import MappingProxyType
from typing import Mapping, Optional

import numpy as np

from caliscope_tpu_torch import persistence
from caliscope_tpu_torch.media.frame_timestamps import FrameTimestamps

logger = logging.getLogger(__name__)

_DEFAULT_FPS_FALLBACK = 30.0

_SyncMapping = dict[int, dict[int, Optional[int]]]


def _earliest_next_frame(cam_id, cursors, frames_by_cam) -> float:
    """Minimum frame_time of NEXT frames from OTHER cameras."""
    times = [
        frames_by_cam[c][cursors[c] + 1]
        for c in cursors
        if c != cam_id and cursors[c] + 1 < len(frames_by_cam[c])
    ]
    return min(times) if times else float("inf")


def _latest_current_frame(cam_id, cursors, frames_by_cam) -> float:
    """Maximum frame_time of CURRENT frames from OTHER cameras."""
    times = [
        frames_by_cam[c][cursors[c]]
        for c in cursors
        if c != cam_id and cursors[c] < len(frames_by_cam[c])
    ]
    return max(times) if times else float("-inf")


@dataclass(frozen=True)
class SynchronizedTimestamps:
    """Constructed via factories; the sync mapping is computed once and
    consumed through frame_for()/time_for()."""

    _camera_timestamps: Mapping[int, FrameTimestamps]

    # ---- queries ------------------------------------------------------------
    @cached_property
    def sync_indices(self) -> list[int]:
        return sorted(self._cache.keys())

    @property
    def cam_ids(self) -> list[int]:
        return sorted(self._camera_timestamps.keys())

    def frame_for(self, sync_index: int, cam_id: int) -> Optional[int]:
        """Frame index for a camera at a sync index; None if dropped."""
        return self._cache[sync_index][cam_id]

    def time_for(self, cam_id: int, frame_index: int) -> float:
        return self._camera_timestamps[cam_id].frame_times[frame_index]

    def for_camera(self, cam_id: int) -> FrameTimestamps:
        return self._camera_timestamps[cam_id]

    @property
    def mean_fps(self) -> float:
        """Mean capture rate from frame-time spans; safe fallback, never 0/inf."""
        rates = []
        for ft in self._camera_timestamps.values():
            times = sorted(ft.frame_times.values())
            if len(times) < 2:
                continue
            span = times[-1] - times[0]
            if span > 0:
                rates.append((len(times) - 1) / span)
        return sum(rates) / len(rates) if rates else _DEFAULT_FPS_FALLBACK

    def to_csv(self, path: Path | str) -> None:
        cams, times = [], []
        for cam_id in self.cam_ids:
            ft = self._camera_timestamps[cam_id]
            for fi in sorted(ft.frame_times.keys()):
                cams.append(cam_id)
                times.append(float(ft.frame_times[fi]))
        persistence.write_csv_columns(
            {"cam_id": np.asarray(cams, np.int64), "frame_time": np.asarray(times, np.float64)}, path
        )

    # ---- the sync algorithm -------------------------------------------------
    @cached_property
    def _cache(self) -> _SyncMapping:
        return self._compute_sync_mapping()

    def _compute_sync_mapping(self) -> _SyncMapping:
        """Greedy forward pass (reference :120-185).

        At each step a camera's candidate frame joins the sync group unless it
        is temporally closer to the other cameras' NEXT frames than to their
        CURRENT frames (then it waits, and this camera records a drop)."""
        frames_by_cam = {
            cid: [ft.frame_times[i] for i in sorted(ft.frame_times.keys())]
            for cid, ft in self._camera_timestamps.items()
        }
        cam_ids = sorted(frames_by_cam.keys())
        cursors = {cid: 0 for cid in cam_ids}
        sync_map: _SyncMapping = {}
        sync_index = 0

        while any(cursors[c] < len(frames_by_cam[c]) for c in cam_ids):
            candidates = {
                cid: frames_by_cam[cid][cursors[cid]]
                for cid in cam_ids
                if cursors[cid] < len(frames_by_cam[cid])
            }
            if not candidates:
                break
            # snapshot the neighbor statistics BEFORE any cursor advances —
            # every camera's decision uses the same instant's view
            e_next = {cid: _earliest_next_frame(cid, cursors, frames_by_cam) for cid in cam_ids}
            l_curr = {cid: _latest_current_frame(cid, cursors, frames_by_cam) for cid in cam_ids}
            assigned: dict[int, Optional[int]] = {}
            for cid in cam_ids:
                if cid not in candidates:
                    assigned[cid] = None
                    continue
                t = candidates[cid]
                if t > e_next[cid] or (e_next[cid] - t) < (t - l_curr[cid]):
                    assigned[cid] = None
                    continue
                assigned[cid] = cursors[cid]
                cursors[cid] += 1
            if any(v is not None for v in assigned.values()):
                sync_map[sync_index] = assigned
                sync_index += 1
            else:
                min_cam = min(candidates, key=lambda c: candidates[c])
                cursors[min_cam] += 1
        return sync_map

    # ---- factories ----------------------------------------------------------
    @classmethod
    def from_csv(cls, recording_dir: Path | str) -> "SynchronizedTimestamps":
        return cls.from_csv_path(Path(recording_dir) / "timestamps.csv")

    @classmethod
    def from_csv_path(cls, csv_path: Path | str) -> "SynchronizedTimestamps":
        """The sync_index column, if present, is ignored — the mapping is
        always recomputed from timestamps."""
        cols = persistence.read_csv_columns(csv_path)
        by_cam: dict[int, list[float]] = {}
        for c, t in zip(cols["cam_id"], cols["frame_time"]):
            by_cam.setdefault(int(float(c)), []).append(float(t))
        cams: dict[int, FrameTimestamps] = {}
        for cam_key in sorted(by_cam):
            times = sorted(by_cam[cam_key])
            cams[cam_key] = FrameTimestamps(MappingProxyType({i: t for i, t in enumerate(times)}))
        logger.debug(f"Loaded timestamps from CSV for {len(cams)} cameras")
        return cls(MappingProxyType(cams))

    @classmethod
    def from_video_paths(cls, videos: Mapping[int, Path]) -> "SynchronizedTimestamps":
        """Infer constant-rate timestamps from each video's metadata."""
        from caliscope_tpu_torch.media.video import read_video_properties

        cams: dict[int, FrameTimestamps] = {}
        for cam_id, path in videos.items():
            props = read_video_properties(path)
            cams[int(cam_id)] = FrameTimestamps.inferred(props.fps, props.frame_count)
        return cls(MappingProxyType(cams))

    @classmethod
    def from_timestamps(cls, camera_timestamps: Mapping[int, FrameTimestamps]) -> "SynchronizedTimestamps":
        return cls(MappingProxyType(dict(camera_timestamps)))
