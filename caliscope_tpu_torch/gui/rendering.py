"""Software rendering helpers for the GUI (numpy -> QImage).

Port of caliscope_tpu/gui/rendering.py.

The reference renders its 3D capture-volume playback with Qt3D
(reference src/caliscope/gui/qt3d/, 917 LoC of scene-graph setup) and
its coverage heatmap with QPainter. Neither Qt3D nor a GPU rasterizer is a
given in this image, so these widgets render with plain numpy — a projected
wireframe rasterizer for the 3D view, histogram + palette mapping for the
heatmap, displacement-grid strokes for the lens visualizer — and hand the
arrays to QLabel via QImage. The same arrays are directly assertable in
headless tests, which Qt3D scene graphs never were.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.gui.qt import QImage, QPixmap

BG = np.array([18, 20, 26], np.uint8)
GRID = np.array([50, 54, 66], np.uint8)
CAMERA_COLORS = np.array(
    [
        [86, 156, 214],
        [220, 163, 86],
        [129, 201, 149],
        [214, 119, 119],
        [181, 137, 214],
        [214, 206, 110],
        [110, 206, 214],
        [214, 137, 181],
    ],
    np.uint8,
)


def to_qimage(rgb: np.ndarray) -> QImage:
    """(H, W, 3) uint8 -> QImage (deep copy; the QImage owns its bytes).

    Under real PySide6, QImage(buffer, ...) keeps a VIEW of the buffer —
    handing it a temporary (tobytes()) leaves the image pointing at freed
    memory. The explicit .copy() detaches it; the headless backend copies
    in its constructor already."""
    from caliscope_tpu_torch.gui.qt import USING_PYSIDE6

    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    img = QImage(rgb.tobytes(), w, h, 3 * w, QImage.Format_RGB888)
    return img.copy() if USING_PYSIDE6 else img


def to_pixmap(rgb: np.ndarray) -> QPixmap:
    return QPixmap.fromImage(to_qimage(rgb))


def draw_points(img: np.ndarray, xy: np.ndarray, color, radius: int = 1) -> None:
    """Stamp filled squares at integer positions (in-place)."""
    h, w = img.shape[:2]
    if len(xy) == 0:
        return
    pts = np.round(np.asarray(xy)).astype(int)
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    pts = pts[ok]
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            x = np.clip(pts[:, 0] + dx, 0, w - 1)
            y = np.clip(pts[:, 1] + dy, 0, h - 1)
            img[y, x] = color


def draw_segments(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color) -> None:
    """Rasterize line segments by dense sampling (in-place).

    p0/p1: (N, 2). Sampling count adapts to the longest segment; for GUI
    wireframes (hundreds of short segments) this vectorizes better than
    per-segment Bresenham in Python.
    """
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    if len(p0) == 0:
        return
    h, w = img.shape[:2]
    lengths = np.linalg.norm(p1 - p0, axis=1)
    n = int(min(max(lengths.max(), 2), 2048))
    t = np.linspace(0.0, 1.0, n)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t  # (N, n, 2)
    pts = pts.reshape(-1, 2)
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    pts = np.round(pts[ok]).astype(int)
    img[np.clip(pts[:, 1], 0, h - 1), np.clip(pts[:, 0], 0, w - 1)] = color


# ---------------------------------------------------------------------------
# Coverage heatmap
# ---------------------------------------------------------------------------

# dark-to-warm ramp (blue -> teal -> yellow -> red), perceptually monotone
_RAMP = np.array(
    [
        [18, 20, 26],
        [38, 70, 120],
        [44, 140, 150],
        [120, 200, 120],
        [230, 210, 90],
        [240, 120, 60],
        [230, 60, 60],
    ],
    float,
)


def colorize(norm: np.ndarray) -> np.ndarray:
    """(H, W) values in [0, 1] -> (H, W, 3) uint8 via the ramp."""
    norm = np.clip(norm, 0.0, 1.0) * (len(_RAMP) - 1)
    lo = np.floor(norm).astype(int)
    hi = np.minimum(lo + 1, len(_RAMP) - 1)
    f = (norm - lo)[..., None]
    return ((1 - f) * _RAMP[lo] + f * _RAMP[hi]).astype(np.uint8)


def render_coverage_heatmap(
    img_xy: np.ndarray, image_size: tuple[int, int], grid: tuple[int, int] = (16, 12), out_scale: int = 24
) -> np.ndarray:
    """Observation-density heatmap over the sensor (reference
    gui/widgets/coverage_heatmap.py). img_xy: (N, 2) pixel coords;
    image_size: (W, H). Returns an RGB uint8 image (upsampled cells)."""
    W, H = image_size
    gx, gy = grid
    if len(img_xy):
        hist, _, _ = np.histogram2d(
            np.asarray(img_xy)[:, 1], np.asarray(img_xy)[:, 0],
            bins=(gy, gx), range=((0, H), (0, W)),
        )
    else:
        hist = np.zeros((gy, gx))
    peak = hist.max()
    norm = hist / peak if peak > 0 else hist
    cells = colorize(norm)
    return np.repeat(np.repeat(cells, out_scale, axis=0), out_scale, axis=1)


# ---------------------------------------------------------------------------
# Lens model visualization
# ---------------------------------------------------------------------------


def render_undistortion_grid(camera, size: int = 360, n_lines: int = 13) -> np.ndarray:
    """Distortion displacement field: a regular grid as seen through the
    lens (reference gui/lens_model_visualizer.py). Straight world lines bow
    according to [k1, k2]; the render distorts ideal grid lines with the
    camera's model."""
    img = np.full((size, size, 3), BG, np.uint8)
    if camera.matrix is None:
        return img
    W, H = camera.size
    sx, sy = size / W, size / H
    fx, fy = camera.matrix[0, 0], camera.matrix[1, 1]
    cx, cy = camera.matrix[0, 2], camera.matrix[1, 2]
    dist = np.zeros(5) if camera.distortions is None else np.asarray(camera.distortions).ravel()
    k1 = dist[0] if len(dist) > 0 else 0.0
    k2 = dist[1] if len(dist) > 1 else 0.0

    def distort(px: np.ndarray) -> np.ndarray:
        x = (px[:, 0] - cx) / fx
        y = (px[:, 1] - cy) / fy
        r2 = x * x + y * y
        g = 1.0 + k1 * r2 + k2 * r2 * r2
        return np.stack([x * g * fx + cx, y * g * fy + cy], axis=1)

    t = np.linspace(0.0, 1.0, 48)
    for i in range(n_lines):
        u = i / (n_lines - 1)
        for horizontal in (True, False):
            if horizontal:
                pts = np.stack([t * W, np.full_like(t, u * H)], axis=1)
            else:
                pts = np.stack([np.full_like(t, u * W), t * H], axis=1)
            d = distort(pts)
            seg = np.stack([d[:-1], d[1:]], axis=1)
            draw_segments(img, seg[:, 0] * [sx, sy], seg[:, 1] * [sx, sy], GRID + 60)
    return img


# ---------------------------------------------------------------------------
# 3D capture-volume renderer (orbit camera, wireframe)
# ---------------------------------------------------------------------------


class Scene3DRenderer:
    """Projects world points + camera frusta through a virtual orbit camera
    and rasterizes a wireframe frame — the software stand-in for the
    reference's Qt3D playback widget (qt3d_playback_widget.py)."""

    def __init__(self, width: int = 640, height: int = 480):
        self.width = width
        self.height = height
        self.azimuth = 35.0  # degrees
        self.elevation = 25.0
        self.distance = 4.0
        self.target = np.zeros(3)

    # ---- virtual camera ------------------------------------------------------
    def _view_matrix(self) -> tuple[np.ndarray, np.ndarray]:
        az = np.deg2rad(self.azimuth)
        el = np.deg2rad(self.elevation)
        eye = self.target + self.distance * np.array(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
        )
        fwd = self.target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up0)
        if np.linalg.norm(right) < 1e-6:
            right = np.array([1.0, 0.0, 0.0])
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        R = np.stack([right, -up, fwd])  # rows: cam x (right), y (down), z (fwd)
        return R, eye

    def project(self, xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """World (N, 3) -> pixel (N, 2) + in-front mask."""
        xyz = np.asarray(xyz, float).reshape(-1, 3)
        R, eye = self._view_matrix()
        pc = (xyz - eye) @ R.T
        z = pc[:, 2]
        ok = z > 1e-6
        f = 1.2 * self.height  # ~45 deg vertical fov
        with np.errstate(divide="ignore", invalid="ignore"):
            u = pc[:, 0] / z * f + self.width / 2
            v = pc[:, 1] / z * f + self.height / 2
        return np.stack([u, v], axis=1), ok

    # ---- rasterization -------------------------------------------------------
    def render(self, world_xyz: np.ndarray, camera_array=None, highlight_xyz=None, wire_lines=None, wire_colors=None) -> np.ndarray:
        """wire_lines: optional (L, 2, 3) world-space segment endpoints with
        (L, 3) float RGB wire_colors in [0, 1] — the playback view model's
        static wireframe topology applied to the current frame buffer."""
        img = np.full((self.height, self.width, 3), BG, np.uint8)
        self._draw_ground_grid(img)
        if camera_array is not None:
            for i, cam in enumerate(sorted(camera_array.cameras.values(), key=lambda c: c.cam_id)):
                if cam.is_posed:
                    self._draw_frustum(img, cam, CAMERA_COLORS[i % len(CAMERA_COLORS)])
        if wire_lines is not None and len(wire_lines):
            wl = np.asarray(wire_lines, float)
            finite = np.isfinite(wl).all(axis=(1, 2))
            p0, ok0 = self.project(wl[finite, 0])
            p1, ok1 = self.project(wl[finite, 1])
            keep = ok0 & ok1
            colors = (
                (np.asarray(wire_colors, float)[finite][keep] * 255).astype(np.uint8)
                if wire_colors is not None
                else None
            )
            if colors is None:
                draw_segments(img, p0[keep], p1[keep], np.array([160, 170, 190], np.uint8))
            else:
                for a, b, c in zip(p0[keep], p1[keep], colors):
                    draw_segments(img, a[None], b[None], c)
        if world_xyz is not None and len(world_xyz):
            finite = np.isfinite(np.asarray(world_xyz)).all(axis=1)
            px, ok = self.project(np.asarray(world_xyz)[finite])
            draw_points(img, px[ok], np.array([210, 214, 220], np.uint8), radius=1)
        if highlight_xyz is not None and len(highlight_xyz):
            finite = np.isfinite(np.asarray(highlight_xyz)).all(axis=1)
            px, ok = self.project(np.asarray(highlight_xyz)[finite])
            draw_points(img, px[ok], np.array([240, 200, 80], np.uint8), radius=2)
        return img

    def _draw_ground_grid(self, img: np.ndarray, extent: float = 2.0, step: float = 0.5) -> None:
        lines = []
        r = np.arange(-extent, extent + step / 2, step)
        for v in r:
            lines.append(((v, -extent, 0.0), (v, extent, 0.0)))
            lines.append(((-extent, v, 0.0), (extent, v, 0.0)))
        p0 = np.array([a for a, _ in lines])
        p1 = np.array([b for _, b in lines])
        q0, ok0 = self.project(p0)
        q1, ok1 = self.project(p1)
        keep = ok0 & ok1
        draw_segments(img, q0[keep], q1[keep], GRID)

    def _draw_frustum(self, img: np.ndarray, cam, color, depth: float = 0.25) -> None:
        # camera center and the four image-corner rays in world coords
        R = cam.rotation
        C = -R.T @ cam.translation.reshape(3)
        W, H = cam.size
        fx, fy = cam.matrix[0, 0], cam.matrix[1, 1]
        cx, cy = cam.matrix[0, 2], cam.matrix[1, 2]
        corners_px = np.array([[0, 0], [W, 0], [W, H], [0, H]], float)
        rays = np.stack([(corners_px[:, 0] - cx) / fx, (corners_px[:, 1] - cy) / fy, np.ones(4)], axis=1)
        world_corners = C[None, :] + (rays * depth) @ R
        pts = np.vstack([C[None, :], world_corners])
        q, ok = self.project(pts)
        if not ok.all():
            return
        apex, quad = q[0], q[1:]
        p0 = np.vstack([np.repeat(apex[None, :], 4, axis=0), quad])
        p1 = np.vstack([quad, np.roll(quad, -1, axis=0)])
        draw_segments(img, p0, p1, color)
        draw_points(img, apex[None, :], color, radius=2)
