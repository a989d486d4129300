"""Seeded views of the chessboard and of ArUco markers, drawn in numpy (no
OpenCV), for the port's tracker tests and chip_smoke.py.

A marker is drawn as cv2.aruco.generateImageMarker draws it: a one-cell
black border around the dictionary's bit cells (bits from the port's
detect/dictionaries.py). A chessboard is drawn square by square. Both are
placed on a white sheet and warped onto a quadrilateral by
`caliscope_tpu_torch.targets.render`; pixel centers are at integers, so the
true corner of a square edge is at .5, and the truth goes through the same
homography.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from caliscope_tpu_torch.detect.dictionaries import get_dictionary
from caliscope_tpu_torch.targets import render

NOISE_GRAY_LEVELS = 1.5
BLUR_SIGMA = 0.8


def marker_image(dictionary: str, marker_id: int, cell_px: int) -> np.ndarray:
    """(cell_px * (n + 2))^2 uint8 image of one marker: black border, bits."""
    d = get_dictionary(dictionary)
    n = d.marker_size
    cells = np.zeros((n + 2, n + 2), np.uint8)
    cells[1:-1, 1:-1] = d.bits[marker_id] * 255
    return np.kron(cells, np.ones((cell_px, cell_px), np.uint8))


def marker_sheet(dictionary: str, placements, sheet_wh: tuple[int, int], cell_px: int):
    """A white sheet with markers at (marker_id, x0, y0) top-left pixels.
    Returns (sheet, {marker_id: (4, 2) corners TL, TR, BR, BL})."""
    w, h = sheet_wh
    sheet = np.full((h, w), 255, np.uint8)
    corners = {}
    for mid, x0, y0 in placements:
        img = marker_image(dictionary, mid, cell_px)
        s = img.shape[0]
        sheet[y0 : y0 + s, x0 : x0 + s] = img
        a, b = x0 - 0.5, y0 - 0.5
        corners[mid] = np.array([[a, b], [a + s, b], [a + s, b + s], [a, b + s]], np.float64)
    return sheet, corners


def chessboard_sheet(squares_rows: int, squares_cols: int, square_px: int, margin_px: int):
    """A (squares_rows x squares_cols)-square chessboard with a white margin,
    top-left square black. Returns (sheet, (N, 2) inner corners in row-major
    order, x fastest — the Chessboard's keypoint order)."""
    h = squares_rows * square_px + 2 * margin_px
    w = squares_cols * square_px + 2 * margin_px
    sheet = np.full((h, w), 255, np.uint8)
    for r in range(squares_rows):
        for c in range(squares_cols):
            if (r + c) % 2 == 0:
                y0, x0 = margin_px + r * square_px, margin_px + c * square_px
                sheet[y0 : y0 + square_px, x0 : x0 + square_px] = 0
    k = np.arange((squares_rows - 1) * (squares_cols - 1))
    inner_cols = squares_cols - 1
    xy = np.stack(
        [margin_px + (k % inner_cols + 1) * square_px - 0.5, margin_px + (k // inner_cols + 1) * square_px - 0.5],
        axis=1,
    )
    return sheet, xy.astype(np.float64)


def _blur3(img: np.ndarray, sigma: float) -> np.ndarray:
    """3 x 3 Gaussian blur (cv2.GaussianBlur((3, 3), sigma) with its
    reflect-101 border), separable, in float64."""
    k = np.exp(-np.array([1.0, 0.0, 1.0]) / (2.0 * sigma * sigma))
    k /= k.sum()
    p = np.pad(img, 1, mode="reflect")
    rows = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    return k[0] * rows[:-2] + k[1] * rows[1:-1] + k[2] * rows[2:]


def grid_error(img_xy: np.ndarray, keypoint_id: np.ndarray, truth: np.ndarray, rows: int, cols: int) -> float:
    """Mean distance of chessboard corners to the truth (rows x cols inner
    corners in print order) under the best of the grid's symmetries
    (identity, 180-degree turn, row or column mirror): the tracker's
    keypoint order follows its lattice basis, which may be any of them."""
    grid = truth.reshape(rows, cols, 2)
    views = [grid, grid[::-1, ::-1], grid[::-1], grid[:, ::-1]]
    return min(float(np.linalg.norm(img_xy - v.reshape(-1, 2)[keypoint_id], axis=1).mean()) for v in views)


def sheet_view(sheet: np.ndarray, quad, out_wh: tuple[int, int], noise_seed: int):
    """Warp `sheet` onto `quad` (TL, TR, BR, BL) in a frame of out_wh, blur
    it as the JAX suite's renders are blurred (3 x 3 Gaussian, sigma 0.8: a
    lens is never perfectly sharp, and the X-corner detector answers the
    staircase of an unblurred edge), squeeze the contrast to 10..245 and add
    seeded sensor noise (noise-free renders tie exactly, and which of equal
    values a top-k keeps is no contract). Returns (frame uint8 (h, w), H
    sheet -> frame)."""
    frame, H = render.board_view(sheet, quad, out_wh)
    frame = _blur3(frame.astype(np.float64), BLUR_SIGMA)
    rng = np.random.default_rng(noise_seed)
    frame = frame * (235.0 / 255.0) + 10.0 + rng.normal(scale=NOISE_GRAY_LEVELS, size=frame.shape)
    return np.clip(np.rint(frame), 0, 255).astype(np.uint8), H


def jittered_quad(rng, out_wh: tuple[int, int], inset: float, jitter: float, aspect: float):
    """A perspective quad of the given width/height aspect, centered in the
    frame `inset` px from the nearer border, each corner moved by up to
    `jitter` px."""
    w, h = out_wh
    bw = w - 2 * inset
    bh = bw / aspect
    if bh > h - 2 * inset:
        bh = h - 2 * inset
        bw = bh * aspect
    x0, y0 = (w - bw) / 2, (h - bh) / 2
    quad = np.array([[x0, y0], [x0 + bw, y0], [x0 + bw, y0 + bh], [x0, y0 + bh]])
    return quad + rng.uniform(-jitter, jitter, size=quad.shape)


def board_pixels_to_meters(charuco, px_per_square: int, margin_squares: float = 0.5) -> np.ndarray:
    """(3, 2) affine map from `charuco.board_image(px_per_square,
    margin_squares)` pixel coordinates to the board plane in meters (the
    frame of `charuco.object_corners()`), fitted on the inner corners."""
    px = render.board_corner_pixels(charuco, px_per_square, margin_squares)
    obj = charuco.object_corners(0)[:, :2]
    A, *_ = np.linalg.lstsq(np.hstack([px, np.ones((len(px), 1))]), obj, rcond=None)
    return A


def board_poses(rng, n: int, K: np.ndarray, wh: tuple[int, int], outline_m: np.ndarray, inset_px: float = 20.0, tilt=(0.1, 0.9)):
    """n board poses (R (3,3), t (3,)) by the JAX suite's recipe
    (tests/test_intrinsics.py: a random axis, a tilt of 0.1-0.9 rad unless
    `tilt` gives another range, lateral offsets, a depth range), each drawn again until the board's outline
    (4, 3) object points, centered on the origin, projects through K at
    least `inset_px` inside the frame and in front of the camera. A tilt
    below pi/2 keeps the printed face towards the camera (the board's y axis
    runs down the image, as the printed image's rows do)."""
    w, h = wh
    f = float(K[0, 0])
    width_m = float(np.ptp(outline_m[:, 0]))
    poses = []
    while len(poses) < n:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(*tilt)
        Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
        z = rng.uniform(1.1, 2.0) * f * width_m / w  # the board spans 1/2 to 9/10 of the width
        t = np.array([rng.uniform(-0.25, 0.25) * z * w / f, rng.uniform(-0.15, 0.15) * z * h / f, z])
        cam = outline_m @ R.T + t
        if (cam[:, 2] <= 0).any():
            continue
        uv = cam[:, :2] / cam[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        if (uv < inset_px).any() or (uv[:, 0] > w - inset_px).any() or (uv[:, 1] > h - inset_px).any():
            continue
        poses.append((R, t))
    return poses


def posed_views(
    sheet: np.ndarray, px_to_m: np.ndarray, K: np.ndarray, wh: tuple[int, int], n: int, seed: int, tilt=(0.1, 0.9)
):
    """n views of a printed `sheet` through the pinhole K (no distortion) at
    board_poses: the quad is K's projection of the sheet's outline (mapped
    to meters by the (3, 2) affine `px_to_m`), the sheet is warped onto it
    by targets/render.py, with seeded sensor noise. Returns (frames (n, h,
    w) uint8, homographies sheet pixels -> frame (n, 3, 3))."""
    rng = np.random.default_rng(seed)
    sh, sw = sheet.shape
    outline_px = np.array([[0, 0], [sw, 0], [sw, sh], [0, sh]], np.float64)
    outline = np.hstack([np.hstack([outline_px, np.ones((4, 1))]) @ px_to_m, np.zeros((4, 1))])
    outline -= outline.mean(axis=0)
    quads = []
    for R, t in board_poses(rng, n, K, wh, outline, tilt=tilt):
        cam = outline @ R.T + t
        quads.append(cam[:, :2] / cam[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]])
    # numpy releases the interpreter lock in the warp's array arithmetic
    with ThreadPoolExecutor(max_workers=8) as pool:
        views = list(pool.map(lambda iq: sheet_view(sheet, iq[1], wh, noise_seed=seed * 1000 + iq[0]), enumerate(quads)))
    return np.stack([f for f, _ in views]), np.stack([H for _, H in views])


def posed_board_views(charuco, px_per_square: int, K: np.ndarray, wh: tuple[int, int], n: int, seed: int):
    """n views of the ChArUco board through the pinhole K at board_poses
    (posed_views). Returns (frames (n, h, w) uint8, truth (n, n_corners, 2))."""
    board = charuco.board_image(px_per_square=px_per_square)
    frames, Hs = posed_views(board, board_pixels_to_meters(charuco, px_per_square), K, wh, n, seed)
    corners_px = render.board_corner_pixels(charuco, px_per_square)
    return frames, np.stack([render.project(H, corners_px) for H in Hs])
