"""Plain-chessboard tracker: X-corners + lattice ordering, all-or-nothing.

Port of caliscope_tpu/trackers/chessboard_tracker.py. The X-corner program
(detect/corners.py::detect_x_corners_device: ring response, NMS top-512, saddle
subpixel) and the pitch-adapted re-refinement run on the tracker's device — the
CUDA device unless `device` names another (it raises without one) — one frame a
call; there they launch the ring-response and window-gather kernels
(csrc/corner_response.cu, csrc/extract_windows.cu). The lattice ordering is
host numpy, as in the reference.

Reference src/caliscope/trackers/chessboard_tracker.py:50 — object_id 0,
keypoint_id = inner-corner index (row-major), detection succeeds only when the
COMPLETE inner grid is found (findChessboardCorners contract); the 180-degree
symmetry caveat applies equally (docs/scripting.md:358-363).

Lattice ordering (replacing cv2's grown-quad graph): detected corners are
organized by estimating the two lattice vectors from nearest-neighbor
difference clustering, assigning integer grid coordinates, then refining with a
homography fit and re-assignment — robust to moderate perspective.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from caliscope_tpu_torch.detect.corners import detect_x_corners_device, refine_corners_subpix
from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.frame_selector import _frame_homography
from caliscope_tpu_torch.packets import PixelFormat, PointPacket
from caliscope_tpu_torch.targets.chessboard import Chessboard
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)


def _order_grid(corners: np.ndarray, inner_rows: int, inner_cols: int, allow_partial: bool = False):
    """Assign detected corners to an (inner_rows x inner_cols) lattice.

    Returns ("complete", keypoint_ids, ordered_xy) covering the FULL grid;
    with allow_partial, a best-effort ("partial", H) where H maps window
    coordinates (c, r) -> image for the most-filled candidate window (the
    caller can project the full grid and snap against a wider candidate
    set); or None.
    """
    n_expected = inner_rows * inner_cols
    if len(corners) < (8 if allow_partial else n_expected):
        return None

    # nearest-neighbor difference vectors
    d2 = np.sum((corners[:, None] - corners[None, :]) ** 2, axis=2)
    np.fill_diagonal(d2, np.inf)
    k = min(4, len(corners) - 1)
    nn = np.argsort(d2, axis=1)[:, :k]
    diffs = corners[nn] - corners[:, None, :]  # (N, k, 2)
    diffs = diffs.reshape(-1, 2)
    # canonicalize direction (half-plane)
    flip = (diffs[:, 0] < 0) | ((diffs[:, 0] == 0) & (diffs[:, 1] < 0))
    diffs[flip] *= -1
    norms = np.linalg.norm(diffs, axis=1)
    med = np.median(norms)
    good = (norms > 0.4 * med) & (norms < 1.8 * med)
    diffs = diffs[good]
    if len(diffs) < 4:
        return None

    # Direction MODES via angle histogram. Under perspective the lattice is
    # anisotropic and a diagonal can be SHORTER than the longer axis (seen on
    # real frames: row 18.6 px, col 27.2 px, diagonal 26.7 px), so a single
    # two-way split may return a (row, diagonal) basis — unimodular but
    # sheared, which the rectangular window search below can never complete.
    # Instead enumerate up to 4 modes (row/col/both diagonals) and try basis
    # PAIRS until the full pipeline succeeds.
    ang = np.arctan2(diffs[:, 1], diffs[:, 0])  # (-pi/2, pi/2] after flip
    nbins = 24
    bins = np.clip(((ang + np.pi / 2) / np.pi * nbins).astype(int), 0, nbins - 1)
    counts = np.bincount(bins, minlength=nbins)
    # circular local maxima on the half-plane (direction space is mod pi)
    modes = []
    for b in range(nbins):
        c = counts[b]
        if c == 0:
            continue
        if c >= counts[(b - 1) % nbins] and c >= counts[(b + 1) % nbins]:
            sel = (bins == b) | (bins == (b - 1) % nbins) | (bins == (b + 1) % nbins)
            v = np.median(diffs[sel], axis=0)
            if np.linalg.norm(v) > 1e-6:
                modes.append((float(np.linalg.norm(v)), v, int(c)))
    # strongest first, cap at 4
    modes.sort(key=lambda m: -m[2])
    modes = modes[:4]
    if len(modes) < 2:
        return None

    def try_basis(v1, v2):
        A = np.stack([v1, v2], axis=1)
        if abs(np.linalg.det(A)) < 1e-6:
            return None
        p0 = corners[np.argmin(corners.sum(axis=1))]
        ab = np.linalg.solve(A, (corners - p0).T).T
        ij = np.round(ab).astype(int)
        resid = np.linalg.norm(ab - ij, axis=1)

        # refine with a homography over confident assignments, then re-assign
        conf = resid < 0.25
        if conf.sum() >= 8:
            H = _frame_homography(ij[conf].astype(float), corners[conf])
            if H is not None:
                Hi = np.linalg.inv(H)
                ones = np.ones((len(corners), 1))
                back = (Hi @ np.hstack([corners, ones]).T).T
                ab = back[:, :2] / back[:, 2:3]
                ij = np.round(ab).astype(int)
                resid = np.linalg.norm(ab - ij, axis=1)

        keep = resid < 0.3
        if not keep.any():
            return None
        ij = ij - ij[keep].min(axis=0)
        grid: dict[tuple[int, int], int] = {}
        for idx in np.where(keep)[0]:
            key = (int(ij[idx, 0]), int(ij[idx, 1]))
            if key not in grid or resid[idx] < resid[grid[key]]:
                grid[key] = int(idx)
        if not grid:
            return None

        # try both axis orientations and every (inner_cols x inner_rows)
        # window of the observed lattice — spurious corners outside the board
        # extend the lattice but never fill a full window; track the MOST
        # FILLED window for the partial fallback
        best_partial = None  # (filled, correspondences)
        for rows_axis in (0, 1):
            cols_axis = 1 - rows_axis
            max_c = max(k[cols_axis] for k in grid)
            max_r = max(k[rows_axis] for k in grid)
            for oc in range(max_c - inner_cols + 2):
                for orr in range(max_r - inner_rows + 2):
                    kps, xy, pairs = [], [], []
                    for r in range(inner_rows):
                        for c in range(inner_cols):
                            cc, rr = c + oc, r + orr
                            key = (cc, rr) if rows_axis == 1 else (rr, cc)
                            idx = grid.get(key)
                            if idx is not None:
                                kps.append(r * inner_cols + c)
                                xy.append(corners[idx])
                                pairs.append(((c, r), corners[idx]))
                    if len(kps) == n_expected:
                        return "complete", np.asarray(kps, np.int64), np.asarray(xy)
                    if allow_partial and (best_partial is None or len(pairs) > best_partial[0]):
                        best_partial = (len(pairs), pairs)
        if allow_partial and best_partial is not None and best_partial[0] >= max(8, n_expected // 3):
            src = np.array([p[0] for p in best_partial[1]], float)
            dst = np.array([p[1] for p in best_partial[1]])
            Hw = _frame_homography(src, dst)
            if Hw is not None:
                return ("partial", best_partial[0], Hw)
        return None

    # candidate basis pairs: sufficiently non-collinear, shortest total first
    pairs = []
    for a in range(len(modes)):
        for b in range(a + 1, len(modes)):
            na, va, _ = modes[a]
            nb, vb, _ = modes[b]
            cosang = abs(np.dot(va, vb)) / (na * nb)
            if cosang < 0.9:  # > ~25 degrees apart
                pairs.append((na + nb, va, vb))
    pairs.sort(key=lambda p: p[0])
    best_partial_result = None
    for _, va, vb in pairs:
        result = try_basis(va, vb)
        if result is None:
            continue
        if result[0] == "complete":
            return result
        if best_partial_result is None or result[1] > best_partial_result[1]:
            best_partial_result = result
    return best_partial_result


def _proximity_clusters(corners: np.ndarray, link: float) -> list[np.ndarray]:
    """Single-linkage clusters (union-find) at the given link distance,
    largest first."""
    n = len(corners)
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    d2 = np.sum((corners[:, None] - corners[None, :]) ** 2, axis=2)
    ii, jj = np.where(np.triu(d2 <= link * link, 1))
    for a, b in zip(ii, jj):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(n)])
    clusters = [np.where(roots == r)[0] for r in np.unique(roots)]
    return sorted(clusters, key=len, reverse=True)


def _subpix_half_width(ordered_xy: np.ndarray, inner_rows: int, inner_cols: int) -> int:
    """Adaptive refinement half-width = clamp(floor(min_pitch / 4), 2, 11):
    a window wider than ~a quarter of the corner pitch drags corners toward
    their neighbors (reference chessboard_tracker.py:30-47 measured 4-8 px
    residual at a fixed 11 px window on 16 px squares vs 0.12 px adapted)."""
    grid = ordered_xy.reshape(inner_rows, inner_cols, 2)
    h = np.linalg.norm(np.diff(grid, axis=1), axis=2)
    v = np.linalg.norm(np.diff(grid, axis=0), axis=2)
    pitch = float(min(h.min(), v.min()))
    return int(np.clip(np.floor(pitch / 4), 2, 11))


class ChessboardTracker(Tracker):
    # k_max 512: on real 720p frames some board corners rank below 256 among
    # clutter X-responses (observed rank 495 on chessboard_intrinsic cam_1)
    def __init__(self, chessboard: Chessboard, k_max: int = 512, device=None):
        """device: the torch device the X-corner program runs on; the CUDA
        device by default, and then it raises when there is none."""
        self.chessboard = chessboard
        self.k_max = k_max
        self.device = resolve_device(device)

    @property
    def name(self) -> str:
        return "CHESSBOARD"

    @property
    def pixel_format(self) -> PixelFormat:
        return PixelFormat.GRAY

    def _snap_full_grid(self, Hw: np.ndarray, cand: np.ndarray):
        """Project the full inner grid through the window homography and snap
        each expected corner to the nearest candidate (local-spacing radius).
        All-or-nothing: every corner must snap uniquely."""
        rows, cols = self.chessboard.inner_rows, self.chessboard.inner_columns
        cr = np.array([[k % cols, k // cols] for k in range(rows * cols)], float)
        ones = np.ones((len(cr), 1))
        p = (Hw @ np.hstack([cr, ones]).T).T
        expected = p[:, :2] / p[:, 2:3]
        # local spacing per corner from projected neighbors
        grid = expected.reshape(rows, cols, 2)
        h = np.linalg.norm(np.diff(grid, axis=1), axis=2)
        v = np.linalg.norm(np.diff(grid, axis=0), axis=2)
        pitch = min(h.min(), v.min())
        d2 = np.sum((expected[:, None] - cand[None]) ** 2, axis=2)
        nearest = np.argmin(d2, axis=1)
        dist = np.sqrt(d2[np.arange(len(expected)), nearest])
        if (dist > 0.35 * pitch).any():
            return None
        if len(set(nearest.tolist())) != len(expected):
            return None
        return np.arange(rows * cols, dtype=np.int64), cand[nearest]

    def _detect(self, frame: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> PointPacket:
        gray = frame if frame.ndim == 2 else frame.mean(axis=2)
        gray32 = np.ascontiguousarray(gray, dtype=np.float32)
        xy, score, valid = detect_x_corners_device(gray32[None], k_max=self.k_max, device=self.device)
        v = valid[0].cpu().numpy()
        cand_all = xy[0].cpu().numpy()[v]
        sc = score[0].cpu().numpy()[v]
        rows, cols = self.chessboard.inner_rows, self.chessboard.inner_columns
        n_expected = rows * cols

        # Real scenes bury the board in clutter X-responses that poison the
        # global lattice statistics. Two defenses, combined progressively:
        # score-ranked top-N subsets (board corners rank high by ChESS
        # response) and proximity clustering at several scales. A subset that
        # yields only a PARTIAL window still establishes the board->image
        # homography, and the full grid is then snapped against ALL
        # candidates — recovering corners whose response rank was buried.
        result = None
        by_score = np.argsort(-sc)
        ladders = [n for n in (96, 160, 256, len(cand_all)) if n <= len(cand_all)]
        tried: set[tuple[int, ...]] = set()
        for N in ladders:
            if result is not None:
                break
            cand = cand_all[by_score[:N]]
            if len(cand) < n_expected // 3:
                continue
            d2 = np.sum((cand[:, None] - cand[None, :]) ** 2, axis=2)
            np.fill_diagonal(d2, np.inf)
            nn = np.sqrt(d2.min(axis=1))
            links = {round(2.2 * float(np.percentile(nn, q)), 1) for q in (30, 60, 85)}
            subsets = [np.arange(len(cand))]
            for link in sorted(links):
                subsets.extend(_proximity_clusters(cand, link))
            for cl in subsets:
                if len(cl) < max(8, n_expected // 3):
                    continue
                key = tuple(sorted(int(by_score[i]) for i in cl)) if len(cl) < len(cand) else ("all", N)
                if key in tried:
                    continue
                tried.add(key)
                res = _order_grid(cand[cl], rows, cols, allow_partial=True)
                if res is None:
                    continue
                if res[0] == "complete":
                    result = (res[1], res[2])
                    break
                snapped = self._snap_full_grid(res[2], cand_all)
                if snapped is not None:
                    result = snapped
                    break

        if result is None:
            return PointPacket.empty()
        kps, img_xy = result

        # Re-refine the ordered corners with a pitch-adapted window.
        win = _subpix_half_width(img_xy, rows, cols)
        refined = (
            refine_corners_subpix(
                torch.as_tensor(gray32[None], device=self.device),
                torch.as_tensor(np.asarray(img_xy, np.float32)[None], device=self.device),
                win=win,
            )[0]
            .cpu()
            .numpy()
        )
        # keep the refinement only where it stayed local (a bad basin can
        # run away on low-contrast corners)
        ok = np.linalg.norm(refined - img_xy, axis=1) < max(2.0, win)
        img_xy = np.where(ok[:, None], refined, img_xy)
        obj = self.chessboard.object_points()[kps]
        return PointPacket(
            object_id=np.zeros(len(kps), np.int64),
            keypoint_id=kps,
            img_loc=img_xy,
            obj_loc=obj,
        )

    def get_point_name(self, keypoint_id: int) -> str:
        return f"corner_{int(keypoint_id)}"

    def get_connected_points(self) -> set[tuple[int, int]]:
        return set(self.chessboard.connectivity())
