"""Deterministic two-phase frame selection for intrinsic calibration.

Port of caliscope_tpu/frame_selector.py (host numpy, as there). The
ChArUco tracker also fits its board homographies with `_frame_homography`.
Reference src/caliscope/core/frame_selector.py:97-578 — Phase 1 picks
orientation-diversity anchors from homography-derived tilt bins (Zhang 2000;
8 x 45-degree bins), Phase 2 greedily adds frames for 5x5 image-grid coverage
with edge/corner weighting, targeting ~30 frames. Emits an
IntrinsicCoverageReport with the same quality metrics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from caliscope_tpu_torch.observations import ImagePoints

GRID_SIZE = 5
N_ORIENTATION_BINS = 8
TARGET_FRAMES = 30
MIN_CORNERS_PER_FRAME = 6
TILT_MIN_DEG = 8.0  # below this the board is effectively fronto-parallel


@dataclass(frozen=True)
class IntrinsicCoverageReport:
    """Selection-quality metrics (reference frame_selector.py:72)."""

    coverage_fraction: float  # 5x5 cells covered / 25 (target > 0.80)
    edge_coverage_fraction: float  # edge cells covered (target > 0.75)
    corner_coverage_fraction: float  # corner cells covered (target > 0.50)
    orientation_sufficient: bool  # >= 4 distinct tilt bins
    orientation_count: int  # bins covered (0-8)
    selected_frames: tuple[int, ...]
    n_candidate_frames: int


def _frame_homography(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray | None:
    """Plain-numpy DLT homography (board plane -> pixels); None if degenerate."""
    n = len(obj_xy)
    if n < 4:
        return None
    # normalize for conditioning
    mo, mi = obj_xy.mean(0), img_xy.mean(0)
    od = obj_xy - mo
    pd = img_xy - mi
    so = np.sqrt(2) / max(float(np.sqrt((od * od).sum(1)).mean()), 1e-9)
    si = np.sqrt(2) / max(float(np.sqrt((pd * pd).sum(1)).mean()), 1e-9)
    o = od * so
    p = pd * si
    # Null vector via the 9x9 normal matrix, assembled blockwise: with
    # a = [x, y, 1] per point and DLT rows r1 = [-a, 0, u*a],
    # r2 = [0, -a, v*a], AtA has the 3x3 block structure
    #   [[ M,  0, -Mu], [ 0,  M, -Mv], [-Mu', -Mv', Muu+Mvv]]
    # built from four (n,3) products; no (2n, 9) A is materialized. After
    # normalization the system is well-conditioned, and eigh of the 9x9
    # costs O(9^3) against a full SVD's O(n * 81).
    a = np.empty((n, 3))
    a[:, :2] = o
    a[:, 2] = 1.0
    u = p[:, 0:1]
    v = p[:, 1:2]
    au = a * u
    av = a * v
    M = a.T @ a
    Mu = a.T @ au
    Mv = a.T @ av
    Muv = au.T @ au + av.T @ av
    AtA = np.zeros((9, 9))
    AtA[0:3, 0:3] = M
    AtA[3:6, 3:6] = M
    AtA[0:3, 6:9] = -Mu
    AtA[6:9, 0:3] = -Mu.T
    AtA[3:6, 6:9] = -Mv
    AtA[6:9, 3:6] = -Mv.T
    AtA[6:9, 6:9] = Muv
    _, vecs = np.linalg.eigh(AtA)
    Hn = vecs[:, 0].reshape(3, 3)
    # denormalize: H = Ti^-1 @ Hn @ To with the similitudes' closed forms
    Ti_inv = np.array([[1.0 / si, 0, mi[0]], [0, 1.0 / si, mi[1]], [0, 0, 1]])
    To = np.array([[so, 0, -so * mo[0]], [0, so, -so * mo[1]], [0, 0, 1]])
    H = Ti_inv @ Hn @ To
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]


def _orientation_features(H: np.ndarray, image_size: tuple[int, int]):
    """(tilt_deg, direction_bin) from the homography's perspective row.

    The board normal's out-of-plane tilt shows up in H's projective terms
    (h31, h32); their direction gives the tilt azimuth, their magnitude
    (scaled by focal proxy = image width) the tilt severity — the same
    Zhang-style signal the reference derives (frame_selector.py:282-420).
    """
    w, _h = image_size
    px, py = H[2, 0] * w, H[2, 1] * w
    mag = float(np.hypot(px, py))
    tilt_deg = float(np.degrees(np.arctan(mag)))
    az = float(np.arctan2(py, px))
    bin_idx = int(((az + 2 * np.pi) % (2 * np.pi)) / (2 * np.pi / N_ORIENTATION_BINS)) % N_ORIENTATION_BINS
    return tilt_deg, bin_idx


def _grid_cells(img_xy: np.ndarray, image_size: tuple[int, int]) -> set[int]:
    w, h = image_size
    cx = np.clip((img_xy[:, 0] / w * GRID_SIZE).astype(int), 0, GRID_SIZE - 1)
    cy = np.clip((img_xy[:, 1] / h * GRID_SIZE).astype(int), 0, GRID_SIZE - 1)
    return set(int(y) * GRID_SIZE + int(x) for x, y in zip(cx, cy))


_EDGE_CELLS = {
    y * GRID_SIZE + x
    for y in range(GRID_SIZE)
    for x in range(GRID_SIZE)
    if x in (0, GRID_SIZE - 1) or y in (0, GRID_SIZE - 1)
}
_CORNER_CELLS = {0, GRID_SIZE - 1, GRID_SIZE * (GRID_SIZE - 1), GRID_SIZE * GRID_SIZE - 1}


def _cell_weight(cell: int) -> float:
    if cell in _CORNER_CELLS:
        return 3.0  # corners are hardest to cover and matter most for distortion
    if cell in _EDGE_CELLS:
        return 2.0
    return 1.0


def select_calibration_frames(
    image_points: ImagePoints,
    cam_id: int,
    image_size: tuple[int, int],
    target_frames: int = TARGET_FRAMES,
) -> tuple[list[int], IntrinsicCoverageReport]:
    """Deterministic 2-phase selection. Returns (selected sync indices, report)."""
    sel = image_points.cam_id == cam_id
    ip = image_points.select(sel)
    frames: dict[int, dict] = {}
    for si in np.unique(ip.sync_index):
        fsel = ip.sync_index == si
        img = ip.img_xy[fsel]
        obj = ip.obj_loc[fsel][:, :2]
        if len(img) < MIN_CORNERS_PER_FRAME or not np.isfinite(obj).all():
            continue
        H = _frame_homography(obj, img)
        if H is None:
            continue
        tilt, ori_bin = _orientation_features(H, image_size)
        frames[int(si)] = {
            "cells": _grid_cells(img, image_size),
            "tilt": tilt,
            "bin": ori_bin,
            "n": len(img),
        }

    if not frames:
        return [], IntrinsicCoverageReport(0.0, 0.0, 0.0, False, 0, (), 0)

    selected: list[int] = []
    covered: set[int] = set()

    # Phase 1: orientation anchors — strongest tilt per occupied bin
    by_bin: dict[int, list[int]] = {}
    for si, f in frames.items():
        if f["tilt"] >= TILT_MIN_DEG:
            by_bin.setdefault(f["bin"], []).append(si)
    for b in sorted(by_bin):
        best = max(by_bin[b], key=lambda si: (frames[si]["tilt"], frames[si]["n"], -si))
        selected.append(best)
        covered |= frames[best]["cells"]

    # Phase 2: greedy coverage with edge/corner weighting
    remaining = [si for si in sorted(frames) if si not in selected]
    while len(selected) < target_frames and remaining:
        def gain(si):
            new = frames[si]["cells"] - covered
            return (sum(_cell_weight(c) for c in new), frames[si]["n"], -si)

        best = max(remaining, key=gain)
        if gain(best)[0] == 0 and len(selected) >= min(target_frames, len(frames)) // 2:
            # nothing new to cover; stop early only after a reasonable base
            if len(selected) >= target_frames // 2:
                break
        selected.append(best)
        covered |= frames[best]["cells"]
        remaining.remove(best)

    selected = selected[:target_frames]

    # Orientation-starved sessions: with < 4 tilt bins among the selection,
    # planar self-calibration is near-degenerate and a small "diverse" subset
    # can steer the solver into an absurd minimum (observed on the real
    # prerecorded_calibration cam_1: 15 frames -> fx collapses to ~130 while
    # all 48 frames give the true ~720). More views of even similar
    # orientations condition the problem, so fall back toward using every
    # candidate frame.
    sel_bins = {frames[si]["bin"] for si in selected if frames[si]["tilt"] >= TILT_MIN_DEG}
    if len(sel_bins) < 4:
        for si in sorted(frames):
            if si not in selected:
                selected.append(si)

    selected = sorted(selected)
    covered = set()
    bins = set()
    for si in selected:
        covered |= frames[si]["cells"]
        if frames[si]["tilt"] >= TILT_MIN_DEG:
            bins.add(frames[si]["bin"])

    report = IntrinsicCoverageReport(
        coverage_fraction=len(covered) / (GRID_SIZE * GRID_SIZE),
        edge_coverage_fraction=len(covered & _EDGE_CELLS) / len(_EDGE_CELLS),
        corner_coverage_fraction=len(covered & _CORNER_CELLS) / len(_CORNER_CELLS),
        orientation_sufficient=len(bins) >= 4,
        orientation_count=len(bins),
        selected_frames=tuple(selected),
        n_candidate_frames=len(frames),
    )
    return selected, report
