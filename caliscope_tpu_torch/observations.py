"""Observation store: validated 2D/3D point tables as structure-of-arrays.

Port of caliscope_tpu/observations.py. Storage is fixed-dtype numpy SoA
(int64 keys + float64 coords) on the host; `ImagePoints.triangulate` runs
the undistortion and the batched DLT on a device. CSV files are the JAX
package's, column for column and byte for byte, written and read without
pandas (persistence.write_csv_columns / read_csv_columns).

Not ported yet: gap filling and `WorldPoints.smooth` (it needs ops/signal).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from caliscope_tpu_torch.persistence import read_csv_columns, write_csv_columns

STATIC_SYNC_INDEX = -1

IMAGE_POINT_COLUMNS = [
    "sync_index",
    "cam_id",
    "object_id",
    "keypoint_id",
    "img_loc_x",
    "img_loc_y",
    "obj_loc_x",
    "obj_loc_y",
    "obj_loc_z",
]

WORLD_POINT_COLUMNS = [
    "sync_index",
    "object_id",
    "keypoint_id",
    "x_coord",
    "y_coord",
    "z_coord",
    "frame_time",
]


def _as_int(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).ravel()


def _as_f64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64)


def _floats(cells: list[str]) -> np.ndarray:
    """CSV cells -> float64, empty cells as NaN (pandas' reading)."""
    return np.array([float(v) if v.strip() else np.nan for v in cells], dtype=np.float64)


def _ints(cells: list[str]) -> np.ndarray:
    return np.array([int(float(v)) for v in cells], dtype=np.int64)


@dataclass
class ImagePoints:
    """Long table of 2D observations keyed by (sync_index, cam_id, object_id,
    keypoint_id) with pixel coords and optional known object-frame coords."""

    sync_index: np.ndarray
    cam_id: np.ndarray
    object_id: np.ndarray
    keypoint_id: np.ndarray
    img_xy: np.ndarray  # (N,2) pixels
    obj_loc: np.ndarray = field(default=None)  # type: ignore[assignment]  # (N,3), NaN when unknown
    frame_time: Optional[np.ndarray] = None  # (N,), NaN allowed

    def __post_init__(self):
        self.sync_index = _as_int(self.sync_index)
        self.cam_id = _as_int(self.cam_id)
        self.object_id = _as_int(self.object_id)
        self.keypoint_id = _as_int(self.keypoint_id)
        self.img_xy = _as_f64(self.img_xy).reshape(-1, 2)
        n = len(self.sync_index)
        if self.obj_loc is None:
            self.obj_loc = np.full((n, 3), np.nan)
        else:
            self.obj_loc = _as_f64(self.obj_loc).reshape(-1, 3)
        if self.frame_time is not None:
            self.frame_time = _as_f64(self.frame_time).ravel()
        for name in ("cam_id", "object_id", "keypoint_id"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"ImagePoints column {name} length mismatch")
        if len(self.img_xy) != n or len(self.obj_loc) != n:
            raise ValueError("ImagePoints coordinate length mismatch")
        if np.isnan(self.img_xy).any():
            raise ValueError("ImagePoints img_loc_x/y must not contain NaN")

    # ---- basics ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.sync_index)

    @property
    def has_obj_loc(self) -> bool:
        return bool(len(self) and np.isfinite(self.obj_loc).all())

    @property
    def any_obj_loc(self) -> bool:
        return bool(len(self) and np.isfinite(self.obj_loc).any())

    def select(self, mask: np.ndarray) -> "ImagePoints":
        mask = np.asarray(mask)
        return ImagePoints(
            self.sync_index[mask],
            self.cam_id[mask],
            self.object_id[mask],
            self.keypoint_id[mask],
            self.img_xy[mask],
            self.obj_loc[mask],
            None if self.frame_time is None else self.frame_time[mask],
        )

    @classmethod
    def empty(cls) -> "ImagePoints":
        return cls(np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0), np.zeros((0, 2)))

    # ---- keys & grouping ---------------------------------------------------
    def point_index(self, static_object_ids: frozenset[int] = frozenset()):
        """Assign each observation a dense 3D-point index. Point identity is
        (sync_index, object_id, keypoint_id), except that static objects
        collapse sync -> STATIC_SYNC_INDEX. Returns (pt_idx (N,), keys (M,3))."""
        sync = self.sync_index.copy()
        if static_object_ids:
            static = np.isin(self.object_id, list(static_object_ids))
            sync[static] = STATIC_SYNC_INDEX
        keys = np.stack([sync, self.object_id, self.keypoint_id], axis=1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        return inverse.astype(np.int64), uniq

    def duplicate_key_count(self) -> int:
        keys = np.stack([self.sync_index, self.cam_id, self.object_id, self.keypoint_id], axis=1)
        return len(keys) - len(np.unique(keys, axis=0))

    # ---- triangulation -----------------------------------------------------
    def triangulate(
        self,
        camera_array,
        static_object_ids: frozenset[int] = frozenset(),
        min_views: int = 2,
        device=None,
        dtype=None,
    ) -> "WorldPoints":
        """Undistort to normalized coords, then batched-DLT triangulate every
        (sync, object, keypoint) group seen by >= min_views posed cameras, on
        `device` (CUDA unless named). Row, point and view counts are bucketed
        exactly as the JAX package buckets them."""
        from caliscope_tpu_torch.device import resolve_device, resolve_dtype
        from caliscope_tpu_torch.ops.bucket import bucket_size, pad_rows
        from caliscope_tpu_torch.ops.projection import undistort_points
        from caliscope_tpu_torch.ops.triangulate import triangulate_groups

        device = resolve_device(device)
        dtype = resolve_dtype(device, dtype)
        views = camera_array.device_views(posed_only=True, device="cpu", dtype=torch.float64)
        if len(self) == 0 or len(views.cam_ids) == 0:
            return WorldPoints.empty()

        id_to_idx = {int(cid): i for i, cid in enumerate(views.cam_ids)}
        obs = self.select(np.isin(self.cam_id, views.cam_ids))
        if len(obs) == 0:
            return WorldPoints.empty()
        cam_idx = np.array([id_to_idx[int(c)] for c in obs.cam_id], dtype=np.int64)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=device, dtype=dt)

        # per-observation undistortion with each observation's K/dist; mixed
        # brown/fisheye rigs run both models and select
        K_obs = views.K.numpy()[cam_idx]
        d_obs = views.dist.numpy()[cam_idx]
        fe_obs = views.fisheye.numpy()[cam_idx]
        N = len(obs)
        Nb = bucket_size(N)
        uv_b = pad_rows(obs.img_xy, Nb)
        K_b = pad_rows(K_obs, Nb)
        K_b[N:] = np.eye(3)
        d_b = pad_rows(d_obs, Nb)
        xn = undistort_points(dev(uv_b), dev(K_b), dev(d_b), False)
        if fe_obs.any():
            xn_fish = undistort_points(dev(uv_b), dev(K_b), dev(d_b[:, :4]), True)
            fe_b = dev(pad_rows(fe_obs, Nb), torch.bool)
            xn = torch.where(fe_b[:, None], xn_fish, xn)

        pt_idx, keys = obs.point_index(static_object_ids)
        n_points = len(keys)
        max_views = min(int(np.bincount(pt_idx, minlength=n_points).max()), 512)
        Pb = bucket_size(n_points + 1)
        xyz, n_views = triangulate_groups(
            dev(views.proj.numpy()),
            dev(pad_rows(cam_idx, Nb), torch.int64),
            xn,
            dev(pad_rows(pt_idx, Nb, fill=Pb - 1), torch.int64),
            Pb,
            bucket_size(max_views, floor=2),
        )
        xyz = xyz[:n_points].cpu().numpy().astype(np.float64)
        keep = n_views[:n_points].cpu().numpy() >= min_views

        ft = np.full(n_points, np.nan)
        if obs.frame_time is not None:
            sums = np.zeros(n_points)
            cnts = np.zeros(n_points)
            good = np.isfinite(obs.frame_time)
            np.add.at(sums, pt_idx[good], obs.frame_time[good])
            np.add.at(cnts, pt_idx[good], 1.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                ft = sums / cnts
        ft[keys[:, 0] == STATIC_SYNC_INDEX] = np.nan

        return WorldPoints(
            sync_index=keys[keep, 0],
            object_id=keys[keep, 1],
            keypoint_id=keys[keep, 2],
            xyz=xyz[keep],
            frame_time=ft[keep],
        )

    # ---- CSV ---------------------------------------------------------------
    def to_csv(self, path: Path | str) -> None:
        cols = {
            "sync_index": self.sync_index,
            "cam_id": self.cam_id,
            "object_id": self.object_id,
            "keypoint_id": self.keypoint_id,
            "img_loc_x": self.img_xy[:, 0],
            "img_loc_y": self.img_xy[:, 1],
            "obj_loc_x": self.obj_loc[:, 0],
            "obj_loc_y": self.obj_loc[:, 1],
            "obj_loc_z": self.obj_loc[:, 2],
        }
        if self.frame_time is not None:
            cols["frame_time"] = self.frame_time
        write_csv_columns(cols, path)

    @classmethod
    def from_csv(cls, path: Path | str) -> "ImagePoints":
        df = read_csv_columns(path)
        missing = [c for c in IMAGE_POINT_COLUMNS[:6] if c not in df]
        if missing:
            raise ValueError(f"ImagePoints missing required columns: {missing}")
        n = len(df["sync_index"])
        obj_loc = None
        if "obj_loc_x" in df and "obj_loc_y" in df:
            # flat-board CSVs may omit obj_loc_z or leave it empty: planar
            # implies z = 0
            z = _floats(df["obj_loc_z"]) if "obj_loc_z" in df else np.full(n, np.nan)
            obj_loc = np.column_stack([_floats(df["obj_loc_x"]), _floats(df["obj_loc_y"]), z])
            xy_ok = np.isfinite(obj_loc[:, :2]).all(axis=1)
            z_nan = ~np.isfinite(obj_loc[:, 2])
            if z_nan[xy_ok].all() and xy_ok.any():
                obj_loc[xy_ok & z_nan, 2] = 0.0
        return cls(
            _ints(df["sync_index"]),
            _ints(df["cam_id"]),
            _ints(df["object_id"]),
            _ints(df["keypoint_id"]),
            np.column_stack([_floats(df["img_loc_x"]), _floats(df["img_loc_y"])]),
            obj_loc,
            _floats(df["frame_time"]) if "frame_time" in df else None,
        )


@dataclass
class WorldPoints:
    """Triangulated 3D points keyed by (sync_index, object_id, keypoint_id)."""

    sync_index: np.ndarray
    object_id: np.ndarray
    keypoint_id: np.ndarray
    xyz: np.ndarray  # (N,3)
    frame_time: Optional[np.ndarray] = None

    def __post_init__(self):
        self.sync_index = _as_int(self.sync_index)
        self.object_id = _as_int(self.object_id)
        self.keypoint_id = _as_int(self.keypoint_id)
        self.xyz = _as_f64(self.xyz).reshape(-1, 3)
        if self.frame_time is None:
            self.frame_time = np.full(len(self.sync_index), np.nan)
        else:
            self.frame_time = _as_f64(self.frame_time).ravel()

    def __len__(self) -> int:
        return len(self.sync_index)

    @classmethod
    def empty(cls) -> "WorldPoints":
        return cls(np.zeros(0), np.zeros(0), np.zeros(0), np.zeros((0, 3)))

    def select(self, mask) -> "WorldPoints":
        mask = np.asarray(mask)
        return WorldPoints(
            self.sync_index[mask],
            self.object_id[mask],
            self.keypoint_id[mask],
            self.xyz[mask],
            self.frame_time[mask],
        )

    def keys(self) -> np.ndarray:
        return np.stack([self.sync_index, self.object_id, self.keypoint_id], axis=1)

    def with_xyz(self, xyz: np.ndarray) -> "WorldPoints":
        return WorldPoints(self.sync_index, self.object_id, self.keypoint_id, xyz, self.frame_time)

    # ---- CSV ---------------------------------------------------------------
    def to_csv(self, path: Path | str) -> None:
        write_csv_columns(
            {
                "sync_index": self.sync_index,
                "object_id": self.object_id,
                "keypoint_id": self.keypoint_id,
                "x_coord": self.xyz[:, 0],
                "y_coord": self.xyz[:, 1],
                "z_coord": self.xyz[:, 2],
                "frame_time": self.frame_time,
            },
            path,
        )

    @classmethod
    def from_csv(cls, path: Path | str) -> "WorldPoints":
        df = read_csv_columns(path)
        return cls(
            _ints(df["sync_index"]),
            _ints(df["object_id"]),
            _ints(df["keypoint_id"]),
            np.column_stack([_floats(df["x_coord"]), _floats(df["y_coord"]), _floats(df["z_coord"])]),
            _floats(df["frame_time"]) if "frame_time" in df else None,
        )
