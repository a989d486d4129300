"""Frames of a ChArUco board seen by a ring of pinhole cameras, rendered on
the device from the seed, with each inner corner's exact image position.

The recipe is the repository's end-to-end workspace recipe
(tests/test_workspace_e2e.py:47-146, as chip_smoke.py's `ws_*` functions
give it in numpy), frozen here so that the yardstick cannot move: the board
image is drawn from the dictionary's bits (dict_4x4_50.json), each frame is
the exact homography warp of it (bilinear taps at H^-1 of each pixel
centre, white outside the board), white where the board is behind the
camera or shows its back, then a separable 3 x 3 Gaussian blur and rounding
to uint8. Pixel centres are at integer coordinates, as the projections are.

Nothing of the program is imported.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

_DICT = Path(__file__).with_name("dict_4x4_50.json")


def rot(axis, ang):
    """Rodrigues' rotation about `axis` by `ang` radians."""
    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def board_image(rows, cols, px, margin_sq=0.5, aruco_scale=0.75):
    """(H, W) uint8 print of a rows x cols-square ChArUco board, markers of
    DICT_4X4_50 on the white squares (OpenCV's layout: the first square
    black, markers in row-major order on squares where row + col is odd)."""
    data = json.loads(_DICT.read_text())
    n = data["marker_size"]
    bits = [np.array([int(c) for c in s], np.uint8).reshape(n, n) for s in data["bits"]]
    m = int(round(margin_sq * px))
    img = np.full((rows * px + 2 * m, cols * px + 2 * m), 255, np.uint8)
    for r in range(rows):
        for c in range(cols):
            if (r + c) % 2 != 1:
                img[m + r * px : m + (r + 1) * px, m + c * px : m + (c + 1) * px] = 0
    a_px = int(round(aruco_scale * px))
    cell = max(a_px // (n + 2), 1)
    used = cell * (n + 2)
    off = (px - used) // 2
    squares = [(c, r) for r in range(rows) for c in range(cols) if (r + c) % 2 == 1]
    for mid, (c, r) in enumerate(squares):
        patch = np.zeros((n + 2, n + 2), np.uint8)
        patch[1:-1, 1:-1] = bits[mid] * 255
        y0, x0 = m + r * px + off, m + c * px + off
        img[y0 : y0 + used, x0 : x0 + used] = np.kron(patch, np.ones((cell, cell), np.uint8))
    return img


def ring_cameras(n, wh, f, radius, height, center):
    """[(K, R, t)] pinhole cameras on a ring, aimed at `center`, zero distortion."""
    center = np.asarray(center, float)
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        c = np.array([radius * np.cos(a), radius * np.sin(a), height])
        z = (center - c) / np.linalg.norm(center - c)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[f, 0, wh[0] / 2], [0, f, wh[1] / 2], [0, 0, 1.0]])
        cams.append((K, R, -R @ c))
    return cams


def station_poses(n_stations, n_per, every, center, board_size_m, rng, jitter_m, jitter_rad):
    """Board poses (R, t) of the session's sweep: the board pauses at
    `n_stations` azimuths, `n_per` frames each, with tilt and height
    variation; every `every`-th frame is kept. Each pose is jittered by up
    to `jitter_m` and `jitter_rad` from the seed (the same number of frames
    and stations for every seed)."""
    center = np.asarray(center, float)
    w, h = board_size_m
    poses = []
    for k in range(0, n_stations * n_per, every):
        station, j = k // n_per, k % n_per
        az = 2 * np.pi * station / n_stations
        tilt = 1.25 + 0.15 * np.sin(2 * np.pi * j / n_per)
        pos = center + np.array(
            [0.05 * np.cos(az + j), 0.05 * np.sin(az + j), 0.12 * np.sin(2 * np.pi * j / n_per + station)]
        )
        Rb = rot([0, 0, 1], az) @ rot([1, 0, 0], tilt) @ rot(rng.normal(size=3), rng.uniform(0, jitter_rad))
        tb = pos - Rb @ np.array([w / 2, h / 2, 0.0]) + rng.uniform(-jitter_m, jitter_m, 3)
        poses.append((Rb, tb))
    return poses


def inner_corners_m(rows, cols, sq):
    """(N, 3) inner corners on the board plane, id = row * (cols - 1) + col."""
    k = np.arange((rows - 1) * (cols - 1))
    return np.stack([(k % (cols - 1) + 1) * sq, (k // (cols - 1) + 1) * sq, np.zeros(len(k))], axis=1)


def view(cam, pose, rows, cols, sq, sq_px, margin_px, wh):
    """(homography board-image px -> image px, or None when the board is
    not drawn (behind the camera, or its back toward it), corner truth
    (N, 2), in-frame mask (N,))."""
    K, R, t = cam
    Rb, tb = pose
    outline = np.array([[0, 0, 0], [cols * sq, 0, 0], [cols * sq, rows * sq, 0], [0, rows * sq, 0]], float)
    world = outline @ Rb.T + tb
    camf = world @ R.T + t
    corners = inner_corners_m(rows, cols, sq) @ Rb.T + tb
    cc = corners @ R.T + t
    uv = (cc / cc[:, 2:3]) @ K.T
    normal = Rb @ np.array([0.0, 0.0, -1.0])  # the printed face looks along board -z
    drawn = (camf[:, 2] >= 0.1).all() and np.dot(-R.T @ t - world.mean(axis=0), normal) > 0.05
    if not drawn:
        return None, uv[:, :2], np.zeros(len(uv), bool)
    q = (camf / camf[:, 2:3]) @ K.T
    src = margin_px + outline[:, :2] / sq * sq_px - 0.5
    H = homography(src, q[:, :2])
    inside = (uv[:, 0] >= 0) & (uv[:, 0] <= wh[0] - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= wh[1] - 1)
    return H, uv[:, :2], inside


def homography(src, dst):
    """The 3 x 3 homography taking the 4 points `src` to `dst` (DLT, float64)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, vt = np.linalg.svd(np.asarray(A, float))
    H = vt[-1].reshape(3, 3)
    return H / H[2, 2]


def warp_blur(board, Hs, wh, sigma, device):
    """(F, h, w) uint8 frames on `device`: frame i is `board` (a uint8
    tensor on the device) warped through Hs[i] (None: a white frame), then
    blurred by the 3-tap Gaussian of `sigma` with reflected edges."""
    w, h = wh
    F = len(Hs)
    out = torch.full((F, h, w), 255, dtype=torch.uint8, device=device)
    idx = [i for i, H in enumerate(Hs) if H is not None]
    if not idx:
        return out
    src = board.to(torch.float32)
    Hb, Wb = src.shape
    padded = torch.full((Hb + 2, Wb + 2), 255.0, device=device)
    padded[1:-1, 1:-1] = src
    flat = padded.reshape(-1)
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device), torch.arange(w, dtype=torch.float64, device=device), indexing="ij"
    )
    Hi = torch.as_tensor(np.stack([np.linalg.inv(Hs[i]) for i in idx]), dtype=torch.float64, device=device)
    k = np.exp(-np.array([1.0, 0.0, 1.0]) / (2.0 * sigma**2))
    k = torch.as_tensor(k / k.sum(), dtype=torch.float32, device=device)
    for s in range(0, len(idx), 8):
        Hc = Hi[s : s + 8, :, :, None, None]
        den = Hc[:, 2, 0] * xs + Hc[:, 2, 1] * ys + Hc[:, 2, 2]
        sx = (Hc[:, 0, 0] * xs + Hc[:, 0, 1] * ys + Hc[:, 0, 2]) / den
        sy = (Hc[:, 1, 0] * xs + Hc[:, 1, 1] * ys + Hc[:, 1, 2]) / den
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = (sx - x0).to(torch.float32), (sy - y0).to(torch.float32)
        x0, y0 = x0.clamp(-2, Wb + 1).to(torch.int64), y0.clamp(-2, Hb + 1).to(torch.int64)
        x1, y1 = (x0 + 2).clamp(0, Wb + 1), (y0 + 2).clamp(0, Hb + 1)
        x0, y0 = (x0 + 1).clamp(0, Wb + 1), (y0 + 1).clamp(0, Hb + 1)
        stride = Wb + 2

        def tap(yy, xx):
            return flat[yy * stride + xx]

        img = (1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x1)) + fy * ((1 - fx) * tap(y1, x0) + fx * tap(y1, x1))
        p = torch.nn.functional.pad(img[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
        rows = k[0] * p[:, :, :-2] + k[1] * p[:, :, 1:-1] + k[2] * p[:, :, 2:]
        blurred = k[0] * rows[:, :-2] + k[1] * rows[:, 1:-1] + k[2] * rows[:, 2:]
        out[idx[s : s + 8]] = torch.clamp(torch.round(blurred), 0, 255).to(torch.uint8)
    return out


def render_rig(cfg, traffic, seed, device):
    """The cell's frames and truth. Returns (frames (C, F, h, w) uint8 on
    `device`, truth (C, F, N, 2) float64, visible (C, F, N) bool, drawn
    (C, F) bool)."""
    rig = cfg["rig"]
    board = cfg["board"]
    wh = tuple(rig["size"])
    rows, cols, sq = board["rows"], board["columns"], board["square_m"]
    sq_px = board["print_px_per_square"]
    margin_px = int(round(0.5 * sq_px))
    rng = np.random.default_rng(seed)
    cams = ring_cameras(rig["cameras"], wh, rig["focal_px"], rig["ring_radius_m"], rig["ring_height_m"], rig["aim_m"])
    ses = cfg["session"]
    poses = station_poses(
        ses["stations"], ses["frames_per_camera_source"] // ses["stations"],
        ses["frames_per_camera_source"] // ses["frames_per_camera"], rig["aim_m"],
        (cols * sq, rows * sq), rng, traffic.get("jitter_m", 0.005), traffic.get("jitter_rad", 0.01),
    )
    img = torch.as_tensor(board_image(rows, cols, sq_px), device=device)
    C, F, N = len(cams), len(poses), (rows - 1) * (cols - 1)
    frames = torch.empty((C, F, wh[1], wh[0]), dtype=torch.uint8, device=device)
    truth = np.zeros((C, F, N, 2))
    visible = np.zeros((C, F, N), bool)
    drawn = np.zeros((C, F), bool)
    for c, cam in enumerate(cams):
        Hs = []
        for f, pose in enumerate(poses):
            H, uv, inside = view(cam, pose, rows, cols, sq, sq_px, margin_px, wh)
            Hs.append(H)
            truth[c, f], visible[c, f], drawn[c, f] = uv, inside, H is not None
        frames[c] = warp_blur(img, Hs, wh, board["blur_sigma"], device)
    return frames, truth, visible, drawn
