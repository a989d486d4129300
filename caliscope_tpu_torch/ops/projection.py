"""The camera projection function and its inverse, on torch tensors.

Port of caliscope_tpu/ops/projection.py.

Camera models:
- Brown-Conrady (``fisheye=False``): distortions = [k1, k2, p1, p2, k3]
  (OpenCV layout). Shorter vectors are zero-padded.
- Fisheye equidistant (``fisheye=True``): distortions = [k1, k2, k3, k4],
  theta_d = theta * (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8).

Intrinsics are passed as K (3,3); skew is ignored. All functions broadcast
over leading axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from caliscope_tpu_torch.ops.lie import so3_exp

N_DIST_BROWN = 5
N_DIST_FISHEYE = 4


def pad_distortions(dist, fisheye: bool):
    """Zero-pad/truncate a distortion vector to the model's canonical length."""
    n = N_DIST_FISHEYE if fisheye else N_DIST_BROWN
    dist = torch.atleast_1d(dist)
    k = dist.shape[-1]
    if k < n:
        dist = F.pad(dist, (0, n - k))
    return dist[..., :n]


def _distort_brown(xn, dist):
    """Normalized undistorted (..., 2) -> normalized distorted (..., 2)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _distort_fisheye(xn, dist):
    """Equidistant model: normalized pinhole (..., 2) -> distorted (..., 2)."""
    k1, k2, k3, k4 = (dist[..., i] for i in range(4))
    x, y = xn[..., 0], xn[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return xn * scale[..., None]


def distort_normalized(xn, dist, fisheye: bool):
    dist = pad_distortions(dist, fisheye)
    return _distort_fisheye(xn, dist) if fisheye else _distort_brown(xn, dist)


def normalized_to_pixels(xn, K):
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], dim=-1)


def pixels_to_normalized(uv, K):
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def _clamp_depth(z, min_depth: float):
    """Sign-preserving minimum depth, so projections stay finite for points
    at or behind the camera (callers mask such observations)."""
    return torch.where(
        torch.abs(z) < min_depth,
        torch.where(z < 0, torch.full_like(z, -min_depth), torch.full_like(z, min_depth)),
        z,
    )


def project_points(X, rvec, tvec, K, dist, fisheye: bool, min_depth: float = 1e-6):
    """World points (..., 3) -> pixel coords (..., 2):
    x_cam = R(rvec) @ X + t; perspective divide; distortion; K."""
    R = so3_exp(rvec)
    xc = torch.einsum("...ij,...j->...i", R, X) + tvec
    z = _clamp_depth(xc[..., 2:3], min_depth)
    xn = xc[..., :2] / z
    xd = distort_normalized(xn, dist, fisheye)
    return normalized_to_pixels(xd, K)


def project_normalized(X, rvec, tvec, min_depth: float = 1e-6):
    """World points -> undistorted normalized image coords (pinhole, K=I)."""
    R = so3_exp(rvec)
    xc = torch.einsum("...ij,...j->...i", R, X) + tvec
    z = _clamp_depth(xc[..., 2:3], min_depth)
    return xc[..., :2] / z


def _undistort_brown_iter(xd, dist, iters: int):
    """Fixed-point inversion of the Brown model (OpenCV-style iteration)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def _undistort_fisheye_iter(xd, dist, iters: int):
    """Newton inversion of theta_d = theta * poly(theta^2); then scale by tan."""
    k1, k2, k3, k4 = (dist[..., i] for i in range(4))
    theta_d = torch.sqrt(torch.clamp(torch.sum(xd * xd, dim=-1), min=1e-18))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        dpoly = theta * (2 * k1 + t2 * (4 * k2 + t2 * (6 * k3 + t2 * 8 * k4)))
        f = theta * poly - theta_d
        fp = poly + theta * dpoly
        theta = theta - f / torch.where(torch.abs(fp) < 1e-12, torch.ones_like(fp), fp)
    scale = torch.tan(theta) / theta_d
    return xd * scale[..., None]


def undistort_points(uv, K, dist, fisheye: bool, output: str = "normalized", iters: int = 20):
    """Remove lens distortion from pixel points (..., 2).

    output='normalized' (K=I plane) or 'pixels' (reproject through K)."""
    dist = pad_distortions(dist, fisheye)
    xd = pixels_to_normalized(uv, K)
    xn = _undistort_fisheye_iter(xd, dist, iters) if fisheye else _undistort_brown_iter(xd, dist, iters)
    if output == "normalized":
        return xn
    return normalized_to_pixels(xn, K)
