"""Synthetic views of a printed target, in plain numpy (no OpenCV).

`homography_from_quad` maps an image's outline onto a quadrilateral;
`warp_perspective` renders the image through a homography by inverse
mapping with bilinear interpolation, as cv2.warpPerspective does with a
constant border. Used to make seeded test and smoke-run frames from
`Charuco.board_image`, with the corners' true positions known through the
same homography.
"""

from __future__ import annotations

import numpy as np


def homography_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The homography taking four points `src` (4, 2) to `dst` (4, 2)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i], b[2 * i + 1] = u, v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def project(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a homography to (N, 2) points."""
    q = np.hstack([pts, np.ones((len(pts), 1))]) @ H.T
    return q[:, :2] / q[:, 2:3]


def warp_perspective(img: np.ndarray, H: np.ndarray, out_wh: tuple[int, int], border_value: float = 255.0) -> np.ndarray:
    """Render uint8 `img` through `H` (source pixel coords -> output pixel
    coords) into a (h, w) uint8 frame: each output pixel samples the source
    bilinearly at H^-1 of its position; taps outside the source take
    `border_value`."""
    w, h = out_wh
    Hs, Ws = img.shape
    # Where the source, grown by the one-pixel apron its bilinear taps reach,
    # lands in front of the view (w > 0 at its corners, so everywhere), only
    # the bounding box of its outline can take a source tap: every other
    # pixel is border_value, and the box is all that is sampled.
    apron = np.array([[-1.0, -1.0, 1.0], [Ws, -1.0, 1.0], [Ws, Hs, 1.0], [-1.0, Hs, 1.0]]) @ np.asarray(H, np.float64).T
    if np.all(apron[:, 2] > 0):
        uv = apron[:, :2] / apron[:, 2:3]
        x0b, y0b = (max(int(np.floor(v)) - 1, 0) for v in uv.min(axis=0))
        x1b, y1b = min(int(np.ceil(uv[:, 0].max())) + 2, w), min(int(np.ceil(uv[:, 1].max())) + 2, h)
        out = np.full((h, w), np.uint8(np.clip(np.rint(border_value), 0, 255)))
        if x0b < x1b and y0b < y1b:
            out[y0b:y1b, x0b:x1b] = _warp_box(img, H, (x0b, x1b), (y0b, y1b), border_value)
        return out
    return _warp_box(img, H, (0, w), (0, h), border_value)


def _warp_box(img: np.ndarray, H: np.ndarray, x_range, y_range, border_value: float) -> np.ndarray:
    """The output pixels x_range[0] <= x < x_range[1], y_range[0] <= y <
    y_range[1] of the warp, each computed as the whole frame's would be."""
    Hs, Ws = img.shape
    ys, xs = np.mgrid[y_range[0] : y_range[1], x_range[0] : x_range[1]].astype(np.float64)
    Hi = np.linalg.inv(H)
    den = Hi[2, 0] * xs + Hi[2, 1] * ys + Hi[2, 2]
    sx = (Hi[0, 0] * xs + Hi[0, 1] * ys + Hi[0, 2]) / den
    sy = (Hi[1, 0] * xs + Hi[1, 1] * ys + Hi[1, 2]) / den
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    padded = np.full((Hs + 2, Ws + 2), float(border_value))
    padded[1:-1, 1:-1] = img

    def tap(yy, xx):
        return padded[np.clip(yy + 1, 0, Hs + 1), np.clip(xx + 1, 0, Ws + 1)]

    out = (1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1)) + fy * (
        (1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)
    )
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def board_view(board_img: np.ndarray, dst_quad, out_wh: tuple[int, int]):
    """Warp a rendered board so that its outline lands on `dst_quad`
    ((4, 2): TL, TR, BR, BL in output pixels). Returns (frame, H) with H
    mapping board-image pixel coords to frame pixel coords."""
    bh, bw = board_img.shape
    src = np.array([[0, 0], [bw, 0], [bw, bh], [0, bh]], np.float64)
    H = homography_from_points(src, np.asarray(dst_quad, np.float64))
    return warp_perspective(board_img, H, out_wh), H


def board_corner_pixels(charuco, px_per_square: int, margin_squares: float = 0.5) -> np.ndarray:
    """(n_corners, 2) positions of the inner chessboard corners in
    `charuco.board_image(px_per_square, margin_squares)` pixel coordinates
    (pixel centers at integers, so an edge between two pixels is at .5)."""
    m = int(round(margin_squares * px_per_square))
    cols = charuco.inner_columns
    k = np.arange(charuco.n_corners)
    return np.stack(
        [m + (k % cols + 1) * px_per_square - 0.5, m + (k // cols + 1) * px_per_square - 0.5], axis=1
    ).astype(np.float64)
