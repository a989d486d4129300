"""Wide labelled CSV + OpenSim TRC export.

Port of caliscope_tpu/export/trc.py (host code). The JAX package builds the
wide table with a pandas pivot; here it is numpy, with the pivot's rules:
one row per sync index (ascending), one `{point_name}_{x,y,z}` column per
point name and axis (names from the tracker, columns sorted as strings),
duplicate (sync, name) rows averaged, NaN skipped, all-NaN rows and columns
dropped. The TRC file is the JAX package's byte for byte (tab-separated,
the standard 4-line header, `\\r\\n` line ends, times rounded to 3 decimals,
coordinates to 6).
"""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from caliscope_tpu_torch.observations import WorldPoints
from caliscope_tpu_torch.persistence import write_csv_columns

logger = logging.getLogger(__name__)

AXES = ("x", "y", "z")


@dataclass
class WideTable:
    """Per-sync wide table: sync_index (S,) ascending, column names (C,)
    sorted, values (S, C) with NaN where a point is missing."""

    sync_index: np.ndarray
    columns: list[str]
    values: np.ndarray

    def __len__(self) -> int:
        return len(self.sync_index)

    def to_csv(self, path: Path | str) -> None:
        """The labelled CSV: sync_index, then the columns."""
        write_csv_columns(
            {"sync_index": self.sync_index, **{c: self.values[:, i] for i, c in enumerate(self.columns)}}, path
        )


def _group_means(group: np.ndarray, n_groups: int, values: np.ndarray) -> np.ndarray:
    """Per-group means of the columns of `values` (N, K), NaN skipped and
    NaN where a group has no value, summed in row order with Kahan's
    compensation, as pandas' groupby mean sums."""
    order = np.argsort(group, kind="stable")
    g = group[order]
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]]) if len(g) else np.zeros(0, int)
    rank = np.arange(len(g)) - np.repeat(starts, np.diff(np.r_[starts, len(g)]))
    K = values.shape[1]
    total, comp, count = np.zeros((n_groups, K)), np.zeros((n_groups, K)), np.zeros((n_groups, K))
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        rows = order[rank == r]
        gi, v = group[rows], values[rows]
        ok = ~np.isnan(v)
        y = v - comp[gi]
        t = total[gi] + y
        c = t - total[gi] - y
        comp[gi] = np.where(ok, np.where(np.isnan(c), 0.0, c), comp[gi])
        total[gi] = np.where(ok, t, total[gi])
        count[gi] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(count > 0, total / count, np.nan)


def xyz_to_wide_labelled(world_points: WorldPoints, tracker) -> WideTable:
    """Long xyz -> wide per-sync table with {point_name}_{x,y,z} columns.

    Single-object assumption (object_id dropped), matching the reference.
    """
    names = np.array([str(tracker.get_point_name(int(k))) for k in world_points.keypoint_id], dtype=object)
    syncs, row = np.unique(world_points.sync_index, return_inverse=True)
    uniq_names, col = np.unique(names, return_inverse=True) if len(names) else (np.array([], object), names)
    S, N = len(syncs), len(uniq_names)
    # NaN where a (sync, name, axis) has no value
    mean = _group_means(row * N + col, S * N, world_points.xyz).reshape(S, N, 3)
    # a (sync, name) group whose three means are all NaN is dropped before
    # the pivot, which leaves the same NaN cells; then all-NaN rows and
    # columns go
    keep_rows = ~np.isnan(mean).reshape(S, -1).all(axis=1)
    mean = mean[keep_rows]
    cols = [(f"{n}_{a}", mean[:, j, i]) for j, n in enumerate(uniq_names) for i, a in enumerate(AXES)]
    cols = sorted((c for c in cols if not np.isnan(c[1]).all()), key=lambda c: c[0])
    values = np.stack([v for _, v in cols], axis=1) if cols else np.zeros((int(keep_rows.sum()), 0))
    return WideTable(syncs[keep_rows], [c for c, _ in cols], values)


def _sync_times(world_points: WorldPoints) -> tuple[np.ndarray, np.ndarray]:
    """Each sync index's mean frame_time (NaN skipped), or sync / 30 when no
    row has a time, shifted to start at 0 and rounded to 3 decimals."""
    syncs, inv = np.unique(world_points.sync_index, return_inverse=True)
    t = _group_means(inv, len(syncs), world_points.frame_time[:, None])[:, 0]
    if np.isnan(t).all():
        t = syncs / 30.0  # no capture timestamps: synthesize 30 fps
    return syncs, np.round(t - np.nanmin(t), 3)


def xyz_to_trc(world_points: WorldPoints, tracker, target_path: Path) -> Path:
    """Write an OpenSim .trc next to target_path (stem reused)."""
    labelled = xyz_to_wide_labelled(world_points, tracker)
    syncs, times = _sync_times(world_points)
    time = times[np.searchsorted(syncs, labelled.sync_index)]
    # sort by time as pandas' sort_values does: quicksort on the non-NaN
    # times, NaN rows last in their order
    idx = np.arange(len(time))
    nan = np.isnan(time)
    order = np.concatenate([idx[~nan][time[~nan].argsort(kind="quicksort")], idx[nan]])
    frames, time, values = labelled.sync_index[order], time[order], labelled.values[order]

    diffs = np.diff(time)
    diffs = diffs[~np.isnan(diffs)]
    rates = 1.0 / diffs[diffs > 0]
    mean_rate = float(rates.sum() / len(rates)) if len(rates) else 30.0

    cols_to_sort = sorted(c for c in labelled.columns if not c.startswith("face"))
    tracked_points = sorted({c.rsplit("_", 1)[0] for c in cols_to_sort if c.endswith(("_x", "_y", "_z"))})
    num_frames = len(labelled) - 1
    col_of = {c: i for i, c in enumerate(labelled.columns)}

    trc_path = Path(target_path.parent, f"{Path(target_path).stem}.trc")
    with open(trc_path, "wt", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["PathFileType", "4", "(X/Y/Z)", str(trc_path)])
        w.writerow(
            ["DataRate", "CameraRate", "NumFrames", "NumMarkers", "Units",
             "OrigDataRate", "OrigDataStartFrame", "OrigNumFrames"]
        )
        w.writerow(
            [int(mean_rate), int(mean_rate), num_frames, len(tracked_points), "m",
             int(mean_rate), 0, num_frames]
        )
        header = ["Frame#", "Time"]
        for name in tracked_points:
            header += [name, "", ""]
        w.writerow(header)
        axis_row = ["", ""]
        for i in range(len(tracked_points)):
            axis_row += [f"X{i + 1}", f"Y{i + 1}", f"Z{i + 1}"]
        w.writerow(axis_row)
        w.writerow([])
        for r in range(len(frames)):
            out = [int(frames[r]), time[r]]
            for name in tracked_points:
                for ax in AXES:
                    j = col_of.get(f"{name}_{ax}")
                    v = np.nan if j is None else values[r, j]
                    out.append("" if np.isnan(v) else round(float(v), 6))
            w.writerow(out)
    logger.info(f"Wrote TRC with {len(tracked_points)} markers, {num_frames} frames -> {trc_path}")
    return trc_path
