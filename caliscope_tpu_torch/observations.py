"""Observation store: validated 2D/3D point tables as structure-of-arrays.

Port of caliscope_tpu/observations.py. Storage is fixed-dtype numpy SoA
(int64 keys + float64 coords) on the host; `ImagePoints.triangulate` runs
the undistortion and the batched DLT on a device. CSV files are the JAX
package's, column for column and byte for byte, written and read without
pandas (persistence.write_csv_columns / read_csv_columns).

Gap filling (`ImagePoints.fill_gaps`, `WorldPoints.fill_gaps`) runs on the
host, vectorized over every track at once (the JAX package loops over
tracks in Python), with the reference's rows, values and order;
`WorldPoints.smooth` runs the zero-phase Butterworth filter (ops/signal.py)
on a device, every track of one length in one call.
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


def _track_order(rows: np.ndarray, sync: np.ndarray, track: tuple[np.ndarray, ...]) -> np.ndarray:
    """`rows` grouped by track and, within a track, in the order the JAX
    package visits them: np.argsort (quicksort) of the track's sync indices
    taken in row order, so that even duplicate observations pair up the
    same way."""
    grouped = rows[np.lexsort(tuple(col[rows] for col in reversed(track)))]  # stable: row order within a track
    keys = np.stack([col[grouped] for col in track], axis=1)
    starts = np.flatnonzero(np.r_[True, (keys[1:] != keys[:-1]).any(axis=1)]) if len(grouped) else np.zeros(0, int)
    ends = np.r_[starts[1:], len(grouped)]
    return np.concatenate([grouped[a:b][np.argsort(sync[grouped[a:b]])] for a, b in zip(starts, ends)] or [grouped])


def _gap_rows(sync: np.ndarray, track: tuple[np.ndarray, ...], max_gap: int):
    """For rows in track order (`_track_order`), one entry per missing sync
    index of a gap of at most max_gap frames: the position of its track's
    first row, of the row before the gap (`src`; src + 1 is the row after
    it), the index's offset from that row's sync (`step`) and the fraction
    of the way across (`frac`, the JAX package's integer quotient)."""
    n = len(sync)
    same = np.ones(max(n - 1, 0), bool)
    for col in track:
        same &= col[1:] == col[:-1]
    starts = np.flatnonzero(np.r_[True, ~same])
    first = np.repeat(starts, np.diff(np.r_[starts, n]))
    gaps = np.diff(sync)
    at = np.flatnonzero(same & (gaps > 1) & (gaps <= max_gap + 1))
    counts = gaps[at] - 1
    src = np.repeat(at, counts)
    step = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts) + 1
    return first[src], src, step, step / np.repeat(gaps[at], counts)


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

    @classmethod
    def concat(cls, parts: list["ImagePoints"]) -> "ImagePoints":
        """Rows of every non-empty part in order; frame_time only when every
        part has one."""
        parts = [p for p in parts if len(p)]
        if not parts:
            return cls.empty()
        ft = None
        if all(p.frame_time is not None for p in parts):
            ft = np.concatenate([p.frame_time for p in parts])
        return cls(
            np.concatenate([p.sync_index for p in parts]),
            np.concatenate([p.cam_id for p in parts]),
            np.concatenate([p.object_id for p in parts]),
            np.concatenate([p.keypoint_id for p in parts]),
            np.concatenate([p.img_xy for p in parts]),
            np.concatenate([p.obj_loc for p in parts]),
            ft,
        )

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

    # ---- gap filling -------------------------------------------------------
    def fill_gaps(self, max_gap: int = 3) -> "ImagePoints":
        """Linearly interpolate missing sync indices within each
        (cam, object, keypoint) track when the gap is <= max_gap frames.
        Filled rows carry the track's obj_loc when its first row has one;
        once any row is filled the result has no frame_time (the JAX
        package's concatenation drops it)."""
        if len(self) == 0 or max_gap <= 0:
            return self
        order = _track_order(np.arange(len(self)), self.sync_index, (self.cam_id, self.object_id, self.keypoint_id))
        first, src, step, frac = _gap_rows(
            self.sync_index[order], (self.cam_id[order], self.object_id[order], self.keypoint_id[order]), max_gap
        )
        if len(src) == 0:
            return self
        i0, i1 = order[src], order[src + 1]
        xy = self.img_xy[i0] + frac[:, None] * (self.img_xy[i1] - self.img_xy[i0])
        track_obj_loc = self.obj_loc[order[first]]
        obj_loc = np.where(np.isfinite(track_obj_loc).all(axis=1)[:, None], track_obj_loc, np.nan)
        new = ImagePoints(
            self.sync_index[i0] + step,
            self.cam_id[i0], self.object_id[i0], self.keypoint_id[i0], xy, obj_loc,
        )
        out = ImagePoints.concat([self, new])
        return out.select(np.lexsort((out.keypoint_id, out.object_id, out.cam_id, out.sync_index)))

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

    # ---- gap filling + smoothing ------------------------------------------
    def fill_gaps(self, max_gap: int = 3) -> "WorldPoints":
        """Linear interpolation of missing sync indices (xyz and frame_time)
        per (obj, kp) track; static rows are never filled."""
        if len(self) == 0 or max_gap <= 0:
            return self
        moving = np.flatnonzero(self.sync_index != STATIC_SYNC_INDEX)
        order = _track_order(moving, self.sync_index, (self.object_id, self.keypoint_id))
        _first, src, step, frac = _gap_rows(
            self.sync_index[order], (self.object_id[order], self.keypoint_id[order]), max_gap
        )
        if len(src) == 0:
            out = self
        else:
            i0, i1 = order[src], order[src + 1]
            new = WorldPoints(
                self.sync_index[i0] + step,
                self.object_id[i0],
                self.keypoint_id[i0],
                self.xyz[i0] + frac[:, None] * (self.xyz[i1] - self.xyz[i0]),
                self.frame_time[i0] + frac * (self.frame_time[i1] - self.frame_time[i0]),
            )
            out = WorldPoints(*(np.concatenate([getattr(self, f), getattr(new, f)])
                                for f in ("sync_index", "object_id", "keypoint_id", "xyz", "frame_time")))
        return out.select(np.lexsort((out.keypoint_id, out.object_id, out.sync_index)))

    def smooth(self, fps: float, cutoff_hz: float = 6.0, order: int = 2, device=None, dtype=None) -> "WorldPoints":
        """Zero-phase Butterworth low-pass per (obj, kp) track, on `device`
        (CUDA unless named) in its default dtype; tracks too short for the
        filter's padding and static rows are left as they are."""
        from caliscope_tpu_torch.device import resolve_device, resolve_dtype
        from caliscope_tpu_torch.ops.signal import butter_lowpass, filtfilt

        if len(self) == 0:
            return self
        device = resolve_device(device)
        dtype = resolve_dtype(device, dtype)
        b, a = butter_lowpass(cutoff_hz, fps, order)
        moving = np.flatnonzero(self.sync_index != STATIC_SYNC_INDEX)
        rows = _track_order(moving, self.sync_index, (self.object_id, self.keypoint_id))
        obj, kp = self.object_id[rows], self.keypoint_id[rows]
        starts = np.flatnonzero(np.r_[True, (obj[1:] != obj[:-1]) | (kp[1:] != kp[:-1])])
        lengths = np.diff(np.r_[starts, len(rows)])
        xyz = self.xyz.copy()
        for n in np.unique(lengths[lengths > 3 * max(len(a), len(b))]):
            idx = rows[starts[lengths == n][:, None] + np.arange(n)[None, :]]  # (tracks, n)
            x = torch.as_tensor(self.xyz[idx].transpose(1, 0, 2).reshape(n, -1), device=device, dtype=dtype)
            y = filtfilt(b, a, x).cpu().numpy().astype(np.float64)
            xyz[idx] = y.reshape(n, -1, 3).transpose(1, 0, 2)
        return self.with_xyz(xyz)

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
