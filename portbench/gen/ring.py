"""Observations of upstream caliscope's canonical ring scene, vectorised.

A frozen numpy copy of the port's `synthetic.factories.default_ring_scene`
(upstream `synthetic/scene_factories.py:21-47`): a ring of identical Brown
cameras (r = 2 m, height 0.8 m, aimed at the origin), a planar grid of
corners on an orbit (radius 0.45 m, height amplitude 0.25 m, tilt amplitude
0.5 rad, one revolution), a point visible when it is in front of the camera
and 5 px inside the frame, and Gaussian pixel noise drawn from the seed in
the scene's row order (sync index, camera, corner). The port's generator
loops in Python over frames and cameras (4.65 s for 8 x 600 on the host);
this one is a few array operations. Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np


def _rodrigues(rv):
    """(..., 3) rotation vectors -> (..., 3, 3) matrices."""
    rv = np.asarray(rv, float)
    th = np.linalg.norm(rv, axis=-1)[..., None, None]
    k = rv / np.maximum(np.linalg.norm(rv, axis=-1, keepdims=True), 1e-300)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K[..., 1, 0], K[..., 2, 0], K[..., 2, 1] = k[..., 2], -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _look_at(position, target, up=(0.0, 0.0, 1.0)):
    """(..., 3, 3) local->world rotations with +z toward `target` (camera style)."""
    z = np.asarray(target, float) - position
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    x = np.cross(z, np.asarray(up, float))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def project(X, R, t, K, dist):
    """Brown (k1, k2, p1, p2, k3) projection of camera-independent points.
    X (..., 3) in the world, R (..., 3, 3) and t (..., 3) world->camera, K
    (3, 3), dist (5,). Returns (uv (..., 2), depth (...))."""
    xc = np.einsum("...ij,...j->...i", R, X) + t
    xn = xc[..., :2] / xc[..., 2:3]
    k1, k2, p1, p2, k3 = dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * K[0, 0] + K[0, 2], yd * K[1, 1] + K[1, 2]], axis=-1), xc[..., 2]


def ring_scene(cfg, seed):
    """The scene of configuration `cfg` with noise from `seed`. Returns a dict:
    cameras (K (C,3,3), dist (C,5), R (C,3,3), t (C,3), size (2,)), board
    (corner grid in its local frame (N,3), the ChArUco frame's corners
    (N,3)), world points (F,N,3), and observation rows (sync, cam, kp,
    uv noisy, uv exact, obj_loc)."""
    rig, board, ses = cfg["rig"], cfg["board"], cfg["session"]
    C, F = rig["cameras"], ses["frames"]
    w, h = rig["size"]
    K = np.array([[rig["focal_px"], 0.0, w / 2.0], [0.0, rig["focal_px"], h / 2.0], [0.0, 0.0, 1.0]])
    dist = np.asarray(rig["distortion"], float)
    ang = 2 * np.pi * np.arange(C) / C
    cpos = np.stack([rig["ring_radius_m"] * np.cos(ang), rig["ring_radius_m"] * np.sin(ang),
                     np.full(C, rig["ring_height_m"])], axis=1)
    Rl = _look_at(cpos, np.zeros(3))  # camera local->world
    R = np.swapaxes(Rl, -1, -2)
    t = -np.einsum("cij,cj->ci", R, cpos)

    rows, cols, sq = board["corner_rows"], board["corner_columns"], board["spacing_m"]
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    local = np.stack([(jj.ravel() - (cols - 1) / 2) * sq, (ii.ravel() - (rows - 1) / 2) * sq, np.zeros(rows * cols)], 1)
    charuco = np.stack([(jj.ravel() + 1) * sq, (ii.ravel() + 1) * sq, np.zeros(rows * cols)], 1)

    orb = ses["orbit"]
    phase = 2 * np.pi * np.arange(F) / max(F - 1, 1)
    pos = np.stack([orb["radius_m"] * np.cos(phase), orb["radius_m"] * np.sin(phase),
                    orb["height_amplitude_m"] * np.sin(2 * phase)], axis=1)
    base = _look_at(pos, pos + pos + np.array([0.0, 0.0, 0.3]))
    tilt = orb["tilt_amplitude_rad"]
    Rb = base @ _rodrigues(np.stack([tilt * np.sin(3 * phase), np.zeros(F), np.zeros(F)], 1)) @ _rodrigues(
        np.stack([np.zeros(F), np.zeros(F), 0.5 * tilt * np.cos(2 * phase)], 1))
    world = np.einsum("fij,nj->fni", Rb, local) + pos[:, None, :]  # (F, N, 3)

    uv, depth = project(world[:, None], R[None, :, None], t[None, :, None], K, dist)  # (F, C, N, ...)
    m = ses["margin_px"]
    vis = (depth > 0.05) & (uv[..., 0] >= m) & (uv[..., 0] <= w - m) & (uv[..., 1] >= m) & (uv[..., 1] <= h - m)
    s_idx, c_idx, k_idx = np.nonzero(vis)  # row-major: the scene's (sync, camera, corner) order
    exact = uv[s_idx, c_idx, k_idx]
    noisy = exact + np.random.default_rng(seed).normal(scale=ses["noise_px"], size=exact.shape)
    return dict(
        K=np.broadcast_to(K, (C, 3, 3)).copy(), dist=np.broadcast_to(dist, (C, 5)).copy(), R=R, t=t,
        size=(w, h), local=local, charuco=charuco, world=world,
        sync=s_idx, cam=c_idx, kp=k_idx, uv=noisy, uv_exact=exact, obj_loc=charuco[k_idx],
    )
