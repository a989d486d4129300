"""Per-camera frame-index -> wall-clock-timestamp mapping.

Port of caliscope_tpu/media/frame_timestamps.py (reference
src/caliscope/recording/frame_timestamps.py: FrameTimestamps, from_csv:48
with rank-ordering, inferred:77). The CSV is read with the standard library
(persistence.read_csv_columns) where the JAX package uses pandas.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from types import MappingProxyType
from typing import Mapping

from caliscope_tpu_torch import persistence


@dataclass(frozen=True)
class FrameTimestamps:
    """frame_index -> timestamp (seconds). Indices may not start at 0 for
    synchronized recordings where cameras started at different times."""

    frame_times: Mapping[int, float]

    @property
    def start_frame_index(self) -> int:
        return min(self.frame_times.keys())

    @property
    def last_frame_index(self) -> int:
        return max(self.frame_times.keys())

    def get_time(self, frame_index: int) -> float:
        return self.frame_times[frame_index]

    def __len__(self) -> int:
        return len(self.frame_times)

    @classmethod
    def from_csv(cls, csv_path: Path | str, cam_id: int) -> "FrameTimestamps":
        """Rank-ordered indices from the cam_id's rows of timestamps.csv."""
        cols = persistence.read_csv_columns(csv_path)
        times = sorted(float(t) for c, t in zip(cols["cam_id"], cols["frame_time"]) if int(float(c)) == cam_id)
        if not times:
            raise KeyError(f"cam_id {cam_id} not found in {csv_path}")
        return cls(MappingProxyType({i: t for i, t in enumerate(times)}))

    @classmethod
    def inferred(cls, fps: float, frame_count: int) -> "FrameTimestamps":
        """Constant-rate timestamps starting at t=0 when no CSV exists."""
        return cls(MappingProxyType({i: i / fps for i in range(frame_count)}))
