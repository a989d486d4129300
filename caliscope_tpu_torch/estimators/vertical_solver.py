"""Gravity-direction fit from a perspective up-field.

Port of caliscope_tpu/estimators/vertical_solver.py. Model: for a pinhole
camera with intrinsics K, the image-space "up" direction at a pixel with
normalized ray p = (x, y, 1) under camera-frame gravity g is
d(x) ∝ (g_xy - p_xy * g_z). The fit minimizes the Huber-robustified
sine-of-angle misfit between that prediction and the observed per-pixel up
directions over g on the unit sphere: Levenberg-Marquardt with a
2-parameter tangent update, renormalized each step, λ x 0.3 on accept and
x 5 on reject (clamped to [1e-10, 1e8]), stopping at an accepted relative
decrease below 1e-10 or after 30 iterations.

The JAX package runs the LM as one jitted `lax.while_loop` per frame; the
port runs a Python loop over device tensors that reads one flag per
iteration, with the 2-column Jacobian in closed form (the chain rule of the
JAX package's `jax.jacfwd` through the renormalization and the
prediction's normalization). One frame per call, as in the JAX package.

The sampling and the statistics of the answer are host numpy, as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from caliscope_tpu_torch.device import resolve_device

MAX_ITERS = 30

# The fit's dtype on every device unless the caller names one. In float32
# the stop test (an accepted relative decrease below 1e-10) lies under an
# ulp of the cost: on an NVIDIA H100 80GB HBM3 at 700 W float32 fits ran
# to the 30-iteration cap, 0.049-0.093 s a camera and up to 0.009 deg from
# the CPU's float64 fit, where float64 stopped in 4-5 iterations,
# 0.0082-0.0194 s (chip_smoke.py's vertical phase, PERF.md).
DEFAULT_DTYPE = torch.float64


@dataclass
class GravityFit:
    gravity_cam: np.ndarray  # (3,) unit vector, camera frame (gravity points down)
    residual_deg: float  # robust mean angular residual
    inlier_fraction: float
    converged: bool
    iterations: int = 0  # LM iterations the fit ran


def _tangent_basis(g):
    e = torch.eye(3, dtype=g.dtype, device=g.device)
    a = torch.where(torch.abs(g[2]) < 0.9, e[2], e[0])
    t1 = torch.linalg.cross(g, a)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1), min=1e-12)
    t2 = torch.linalg.cross(g, t1)
    return t1, t2


def _predicted_up(g, pn):
    """Image-space up direction (unnormalized) at normalized points pn (N,2)."""
    return torch.stack([g[0] - pn[:, 0] * g[2], g[1] - pn[:, 1] * g[2]], dim=1)


def _residuals(g, pn, up_obs, weights):
    """Sine-of-angle residual between predicted and observed up directions."""
    pred = _predicted_up(g, pn)
    norm = torch.clamp(torch.linalg.norm(pred, dim=1), min=1e-9)
    pred = pred / norm[:, None]
    cross = pred[:, 0] * up_obs[:, 1] - pred[:, 1] * up_obs[:, 0]
    return cross * weights


def _residuals_and_jacobian(g, t1, t2, pn, up_obs, weights):
    """r (N,) at g and J (N,2) = dr/dθ of r(normalize(g + θ1 t1 + θ2 t2))
    at θ = 0, in closed form."""
    n = torch.clamp(torch.linalg.norm(g), min=1e-12)
    gn = g / n
    T = torch.stack([t1, t2], dim=1)  # (3,2)
    # d normalize(u)/dθ at u = g: (t - gn (gn . t)) / n; the clamp's
    # derivative is zero only where |g| < 1e-12, which a unit g never is
    dg = (T - gn[:, None] * (gn @ T)[None, :]) / n  # (3,2)
    pred = _predicted_up(gn, pn)  # (N,2)
    dpx = dg[0][None, :] - pn[:, 0:1] * dg[2][None, :]  # (N,2) over θ
    dpy = dg[1][None, :] - pn[:, 1:2] * dg[2][None, :]
    raw = torch.linalg.norm(pred, dim=1)
    live = raw > 1e-9
    norm = torch.clamp(raw, min=1e-9)
    # d(pred / |pred|) = dpred / |pred| - pred (pred . dpred) / |pred|^3 (the
    # second term is absent where the clamp holds the norm at 1e-9)
    dot = pred[:, 0:1] * dpx + pred[:, 1:2] * dpy
    corr = torch.where(live[:, None], dot / norm[:, None] ** 3, 0.0)
    dqx = dpx / norm[:, None] - pred[:, 0:1] * corr
    dqy = dpy / norm[:, None] - pred[:, 1:2] * corr
    q = pred / norm[:, None]
    r = (q[:, 0] * up_obs[:, 1] - q[:, 1] * up_obs[:, 0]) * weights
    J = (dqx * up_obs[:, 1:2] - dqy * up_obs[:, 0:1]) * weights[:, None]
    return r, J


def _fit_one(pn, up_obs, weights, g0, huber_delta: float, iters: int = MAX_ITERS):
    """The LM on the sphere: (g, residuals at g, iterations, done)."""

    def huber_w(r):
        a = torch.abs(r)
        return torch.where(a <= huber_delta, 1.0, huber_delta / torch.clamp(a, min=1e-12))

    def cost(g):
        r = _residuals(g, pn, up_obs, weights)
        a = torch.abs(r)
        rho = torch.where(a <= huber_delta, 0.5 * r**2, huber_delta * (a - 0.5 * huber_delta))
        return torch.sum(rho)

    g = g0
    lam = torch.tensor(1e-3, dtype=g0.dtype, device=g0.device)
    c = cost(g)
    it, done = 0, False
    while it < iters and not done:
        t1, t2 = _tangent_basis(g)
        r, J = _residuals_and_jacobian(g, t1, t2, pn, up_obs, weights)
        Jw = J * huber_w(r)[:, None]
        H = Jw.T @ J
        grad = Jw.T @ r
        d = torch.clamp(torch.diagonal(H), min=1e-12)
        th = -torch.linalg.solve(H + lam * torch.diag(d), grad)
        g_new = g + th[0] * t1 + th[1] * t2
        g_new = g_new / torch.clamp(torch.linalg.norm(g_new), min=1e-12)
        c_new = cost(g_new)
        accept = c_new < c
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e8)
        g = torch.where(accept, g_new, g)
        rel = (c - c_new) / torch.clamp(c, min=1e-30)
        done_t = accept & (rel < 1e-10)
        c = torch.where(accept, c_new, c)
        it += 1
        done = bool(done_t)  # the one device->host read of the iteration
    return g, _residuals(g, pn, up_obs, weights), it, done


def fit_gravity(
    up_field: np.ndarray,
    K: np.ndarray,
    sample_stride: int = 8,
    weights: np.ndarray | None = None,
    huber_delta: float = 0.1,
    device=None,
    dtype=None,
) -> GravityFit:
    """Fit camera-frame gravity from a dense up-field, on `device` (CUDA
    unless named), in `dtype` (DEFAULT_DTYPE, float64, unless named).

    Args:
        up_field: (H, W, 2) unit image-space up directions per pixel.
        K: (3, 3) camera intrinsics.
        sample_stride: subsample the field for the fit.
        weights: optional (H, W) confidence weights.
    """
    device = resolve_device(device)
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    H, W = up_field.shape[:2]
    ys, xs = np.mgrid[0:H:sample_stride, 0:W:sample_stride]
    xs, ys = xs.ravel(), ys.ravel()
    up = up_field[ys, xs]
    norm = np.linalg.norm(up, axis=1)
    good = norm > 1e-6
    xs, ys, up = xs[good], ys[good], up[good] / norm[good][:, None]
    w = np.ones(len(xs)) if weights is None else weights[ys, xs]

    pn = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1]], axis=1)
    # init: the mean observed up direction lifted to a 3D guess
    mu = up.mean(axis=0)
    g0 = np.array([mu[0], mu[1], 0.0])
    n0 = np.linalg.norm(g0)
    g0 = g0 / n0 if n0 > 1e-9 else np.array([0.0, 1.0, 0.0])

    on = dict(dtype=dtype, device=device)
    g, r, it, done = _fit_one(
        torch.as_tensor(pn, **on), torch.as_tensor(up, **on), torch.as_tensor(w, **on), torch.as_tensor(g0, **on),
        huber_delta,
    )
    g = g.cpu().numpy().astype(np.float64)
    r = r.cpu().numpy().astype(np.float64)
    ang = np.degrees(np.arcsin(np.clip(np.abs(r / np.maximum(w, 1e-9)), 0, 1)))
    return GravityFit(
        gravity_cam=g,
        residual_deg=float(np.median(ang)),
        inlier_fraction=float(np.mean(ang < 5.0)),
        # as the JAX package reports it: any fit that ran an iteration
        converged=bool(done) or it > 0,
        iterations=it,
    )
