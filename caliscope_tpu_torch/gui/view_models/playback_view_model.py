"""Framework-agnostic view model for 3D capture-volume playback.

Port of caliscope_tpu/gui/view_models/playback_view_model.py.

Parity: reference src/caliscope/gui/view_models/playback_view_model.py:1 —
the renderer-facing contract for point playback:

- a CANONICAL point map: the superset of (object_id, keypoint_id) pairs
  across the whole recording, each assigned a fixed buffer index, so every
  frame renders from a FIXED-SIZE (N, 3) buffer (missing points = NaN —
  renderers move NaN off-screen / skip them without reallocating);
- static wireframe topology resolved once from point ids to buffer index
  pairs;
- per-frame geometry lookup pre-grouped by sync_index (no full-table scan
  per frame);
- static points (rigid objects triangulated once at STATIC_SYNC_INDEX)
  composited into every frame;
- camera-only mode for pre-reconstruction previews.

Consumed by gui/widgets/playback_3d.py's software renderer; the same
buffers would feed a GPU scene graph unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, WorldPoints

_COLOR_RGB = {
    "r": (0.86, 0.30, 0.30), "g": (0.36, 0.73, 0.46), "b": (0.33, 0.53, 0.83),
    "c": (0.35, 0.78, 0.82), "m": (0.78, 0.45, 0.82), "y": (0.88, 0.82, 0.35),
    "k": (0.15, 0.15, 0.17), "w": (0.85, 0.86, 0.88),
}


@dataclass
class FrameGeometry:
    """Raw buffers for one frame, renderer-ready."""

    points: np.ndarray  # (N, 3) float32, NaN where missing this frame
    colors: np.ndarray  # (N, 3) float32 RGB


class PlaybackViewModel:
    def __init__(self, camera_array, world_points: WorldPoints | None = None, wireframe=None, fps: int = 30):
        self.camera_array = camera_array
        self.world_points = world_points
        self.wireframe = wireframe
        self.frame_rate = fps

        if world_points is None or len(world_points) == 0:
            self.all_point_keys: list[tuple[int, int]] = []
            self.n_points = 0
            self.id_to_index: dict[tuple[int, int], int] = {}
            self._static_lines = np.empty((0, 2), np.int32)
            self._static_line_colors = np.empty((0, 3), np.float32)
            self._frames: dict[int, np.ndarray] = {}
            return

        # 1. canonical point map: sorted unique (object_id, keypoint_id)
        keys = np.stack([world_points.object_id, world_points.keypoint_id], axis=1)
        uniq = np.unique(keys, axis=0)
        self.all_point_keys = [(int(o), int(k)) for o, k in uniq]
        self.n_points = len(self.all_point_keys)
        self.id_to_index = {key: i for i, key in enumerate(self.all_point_keys)}

        # 2. wireframe topology -> buffer index pairs (resolved once)
        self._static_lines, self._static_line_colors = self._build_static_topology()

        # 3. pre-group rows by sync_index: each entry is an (M, 4) array of
        #    [buffer_index, x, y, z] — vectorized scatter per frame
        row_index = np.array(
            [self.id_to_index[(int(o), int(k))] for o, k in keys], np.int64
        )
        self._frames = {}
        order = np.argsort(world_points.sync_index, kind="stable")
        sync_sorted = world_points.sync_index[order]
        bounds = np.flatnonzero(np.diff(sync_sorted)) + 1
        for chunk in np.split(order, bounds):
            s = int(world_points.sync_index[chunk[0]])
            self._frames[s] = np.concatenate(
                [row_index[chunk, None].astype(np.float64), world_points.xyz[chunk]], axis=1
            )

    # ---- constructors --------------------------------------------------------
    @classmethod
    def from_xyz_csv(cls, xyz_path: str | Path, camera_array, wireframe=None, fps: int = 30) -> "PlaybackViewModel":
        return cls(camera_array, WorldPoints.from_csv(xyz_path), wireframe, fps)

    @classmethod
    def from_camera_array_only(cls, camera_array) -> "PlaybackViewModel":
        """Camera frustums only — preview mode before reconstruction."""
        return cls(camera_array)

    # ---- ranges --------------------------------------------------------------
    @property
    def has_points(self) -> bool:
        return self.n_points > 0

    @property
    def valid_sync_indices(self) -> np.ndarray:
        """Sorted sync indices that actually carry data (the scrub slider
        stops only on these — sparse recordings skip empty indices)."""
        keys = [k for k in self._frames if k != STATIC_SYNC_INDEX]
        return np.sort(np.asarray(keys, np.int64))

    @property
    def min_index(self) -> int:
        v = self.valid_sync_indices
        return int(v[0]) if len(v) else 0

    @property
    def max_index(self) -> int:
        v = self.valid_sync_indices
        return int(v[-1]) if len(v) else 0

    # ---- cameras -------------------------------------------------------------
    def get_camera_positions(self) -> np.ndarray | None:
        """(n_cameras, 3) world centers (C = -R^T t) of posed cameras."""
        centers = [
            -cam.rotation.T @ cam.translation.reshape(3)
            for cam in self.camera_array.cameras.values()
            if getattr(cam, "is_posed", False)
        ]
        return np.asarray(centers) if centers else None

    # ---- geometry ------------------------------------------------------------
    def get_static_wireframe_data(self) -> tuple[np.ndarray, np.ndarray]:
        return self._static_lines, self._static_line_colors

    def get_frame_geometry(self, sync_index: int) -> FrameGeometry:
        """Fixed-size (N, 3) buffer for one frame; NaN = missing."""
        points = np.full((self.n_points, 3), np.nan, np.float32)
        colors = np.full((self.n_points, 3), 0.8, np.float32)
        rows = self._frames.get(int(sync_index))
        if rows is not None:
            points[rows[:, 0].astype(np.int64)] = rows[:, 1:].astype(np.float32)
        if int(sync_index) != STATIC_SYNC_INDEX:
            static = self._frames.get(STATIC_SYNC_INDEX)
            if static is not None:
                points[static[:, 0].astype(np.int64)] = static[:, 1:].astype(np.float32)
        return FrameGeometry(points=points, colors=colors)

    def _build_static_topology(self) -> tuple[np.ndarray, np.ndarray]:
        lines, colors = [], []
        if self.wireframe is not None:
            for seg in self.wireframe.segments:
                a = self.wireframe.point_names.get(seg.point_A)
                b = self.wireframe.point_names.get(seg.point_B)
                if a is None or b is None:
                    continue
                ka, kb = (0, int(a)), (0, int(b))
                if ka in self.id_to_index and kb in self.id_to_index:
                    lines.append([self.id_to_index[ka], self.id_to_index[kb]])
                    colors.append(_COLOR_RGB.get(seg.color, _COLOR_RGB["w"]))
        if not lines:
            return np.empty((0, 2), np.int32), np.empty((0, 3), np.float32)
        return np.asarray(lines, np.int32), np.asarray(colors, np.float32)
