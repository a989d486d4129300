"""Intrinsic calibration: Zhang closed-form init + batched joint LM.

Port of caliscope_tpu/solvers/intrinsics.py (which replaces
cv2.calibrateCamera / cv2.fisheye.calibrate):

1. Per-frame planar homographies — one masked, batched DLT over all selected
   frames (ops/pnp.homography_dlt), not a per-frame loop.
2. Zhang (2000) closed-form K from the homography constraints (the B-matrix
   eigen problem), plus pose-from-homography per frame for extrinsic inits.
3. Joint Levenberg-Marquardt over [fx, fy, cx, cy, dist...] + 6 params/frame,
   pixel residuals, dense normal equations of dimension 4 + n_dist + 6F
   solved with a dense LU. The JAX package runs the loop inside
   `lax.while_loop`; here it is a Python loop on the device with one
   device->host read of the stop flag per iteration (counted in
   `IntrinsicSolveResult.host_reads`), and J is the closed form of the
   residual's derivative (`_jacobian`), where the reference takes
   `jax.jacfwd`: the tests hold it to `torch.func.jacfwd` of `_residuals`.
   Forward-mode autodiff costs a few thousand dispatched operations an
   iteration, which bound the loop on the card; the closed form a few
   dozen.

Both camera models: Brown-Conrady (5 coef) and fisheye-equidistant (4 coef).
The solve runs on the CUDA device unless the caller passes ``device="cpu"``,
in float64 on either unless ``dtype`` is given. That departs from the port's
float32 rule on CUDA: in float32 the reference's stop test (a relative cost
change below 1e-10, under one float32 ulp) is never met, so every float32
solve runs to its iteration cap, while a float64 solve of the same input
stops after a dozen iterations; the system is small (9 + 6F unknowns, a few
hundred at the 30-frame budget).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.ops.bucket import bucket_size
from caliscope_tpu_torch.ops.lie import so3_exp, so3_exp_jacobian
from caliscope_tpu_torch.ops.pnp import homography_dlt, pose_from_homography
from caliscope_tpu_torch.ops.projection import _clamp_depth, project_points


@dataclass
class IntrinsicSolveResult:
    K: np.ndarray  # (3,3)
    dist: np.ndarray  # (5,) brown / (4,) fisheye
    rvecs: np.ndarray  # (F,3) per-frame board->camera
    tvecs: np.ndarray  # (F,3)
    rmse: float  # pixel RMSE over used observations
    n_frames: int
    converged: bool
    n_iterations: int
    restarted: bool = False  # the plausibility restart from the neutral K ran
    host_reads: int = 0  # device->host reads of the solve (stop flags, checks)
    n_frames_bucketed: int = 0  # F after bucketing to a power of two (floor 8)
    seconds: float = 0.0  # wall time of the solve, its last device->host reads included


def _zhang_b(H, mask):
    """The 6-vector b of B = K^-T K^-1 (Zhang 2000): the null vector of V."""

    def v_ij(i, j):
        return torch.stack(
            [
                H[..., 0, i] * H[..., 0, j],
                H[..., 0, i] * H[..., 1, j] + H[..., 1, i] * H[..., 0, j],
                H[..., 1, i] * H[..., 1, j],
                H[..., 2, i] * H[..., 0, j] + H[..., 0, i] * H[..., 2, j],
                H[..., 2, i] * H[..., 1, j] + H[..., 1, i] * H[..., 2, j],
                H[..., 2, i] * H[..., 2, j],
            ],
            dim=-1,
        )

    V = torch.cat([v_ij(0, 1), v_ij(0, 0) - v_ij(1, 1)], dim=0)  # (2F,6)
    m2 = torch.cat([mask, mask], dim=0).to(V.dtype)[:, None]
    V = V * m2
    _, vecs = torch.linalg.eigh(V.T @ V)
    return vecs[:, 0]


def _k_from_zhang_b(b):
    """Closed-form factorization of B (Zhang appendix B). Invariant to the
    sign of b, which eigh leaves to the backend."""
    B11, B12, B22, B13, B23, B33 = b
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12**2)
    lam = B33 - (B13**2 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12**2)))
    gamma = -B12 * alpha**2 * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha**2 / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([alpha, zero, u0]), torch.stack([zero, beta, v0]), torch.stack([zero, zero, one])])


def zhang_intrinsics_from_homographies(H, mask):
    """Closed-form K from planar homographies (Zhang 2000).

    H: (F,3,3) board-plane -> pixel homographies; mask: (F,) valid frames.
    Solves V b = 0 for B = K^-T K^-1 (6-vector, symmetric), then factors K.
    A B that is not positive definite gives NaNs or a non-physical K, which
    the caller replaces with its centered fallback.
    """
    return _k_from_zhang_b(_zhang_b(H, mask))


def _intrinsic_matrix(params, fix_aspect: bool):
    fx = params[0]
    fy = params[0] if fix_aspect else params[1]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack(
        [torch.stack([fx, zero, params[2]]), torch.stack([zero, fy, params[3]]), torch.stack([zero, zero, one])]
    )


def _residuals(params, obj_pts, img_pts, mask, n_dist: int, fisheye: bool, fix_aspect: bool):
    """params = [fx, fy, cx, cy, dist(n_dist)] + per-frame [rvec(3), t(3)].
    Returns masked pixel residuals (F, K, 2)."""
    K = _intrinsic_matrix(params, fix_aspect)
    dist = params[4 : 4 + n_dist]
    pose = params[4 + n_dist :].reshape(-1, 6)
    uv = project_points(obj_pts, pose[:, None, 0:3], pose[:, None, 3:6], K, dist, fisheye)
    return (uv - img_pts) * mask[..., None]


def _jacobian(params, obj_pts, mask, n_dist: int, fisheye: bool, fix_aspect: bool):
    """d _residuals / d params in closed form, (F*K*2, 4 + n_dist + 6F): the
    chain rule through the distortion model, the perspective divide (whose
    depth clamp has no slope) and so3_exp, equal to forward-mode autodiff of
    _residuals to roundoff. Intrinsic columns are dense; each frame's six
    pose columns are nonzero on its own rows only."""
    F, Kc = obj_pts.shape[:2]
    fx = params[0]
    fy = params[0] if fix_aspect else params[1]
    dist = params[4 : 4 + n_dist]
    pose = params[4 + n_dist :].reshape(F, 6)
    xc = torch.einsum("fij,fkj->fki", so3_exp(pose[:, :3]), obj_pts) + pose[:, None, 3:]
    z = _clamp_depth(xc[..., 2], 1e-6)
    x, y = xc[..., 0] / z, xc[..., 1] / z
    r2 = x * x + y * y
    if fisheye:
        r = torch.sqrt(torch.clamp(r2, min=1e-18))
        th = torch.atan(r)
        t2 = th * th
        k1, k2, k3, k4 = dist
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        thd = th * poly
        sc = thd / r
        xd, yd = x * sc, y * sc
        dthd = poly + 2.0 * t2 * (k1 + t2 * (2.0 * k2 + t2 * (3.0 * k3 + 4.0 * k4 * t2)))  # d thd / d th
        dr = torch.where(r2 > 1e-18, 0.5 / r, torch.zeros_like(r))  # d r / d r2 (the clamp has no slope)
        dsc = (dthd / (1.0 + r * r) / r - thd / (r * r)) * dr  # d sc / d r2
        dxx, dxy, dyy = sc + 2.0 * x * x * dsc, 2.0 * x * y * dsc, sc + 2.0 * y * y * dsc
        dyx = dxy
        ddist = [(x * th * t2**i / r, y * th * t2**i / r) for i in range(1, 5)]
    else:
        k1, k2, p1, p2, k3 = dist
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        drad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d radial / d r2
        dxx = radial + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
        dxy = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
        dyy = radial + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
        dyx = dxy
        ddist = [(x * r2, y * r2), (x * r2 * r2, y * r2 * r2), (2.0 * x * y, r2 + 2.0 * y * y),
                 (r2 + 2.0 * x * x, 2.0 * x * y), (x * r2**3, y * r2**3)]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    intr = [
        (xd, yd if fix_aspect else zero),  # fx
        (zero, zero if fix_aspect else yd),  # fy
        (one, zero),  # cx
        (zero, one),  # cy
    ] + [(fx * a, fy * b) for a, b in ddist]
    # d(x, y)/d xc, then d(u, v)/d xc
    inv_z = 1.0 / z
    dz = torch.where(torch.abs(xc[..., 2]) < 1e-6, zero, inv_z)
    dx_dxc, dy_dxc = (inv_z, zero, -x * dz), (zero, inv_z, -y * dz)
    du_dxc = torch.stack([fx * (dxx * dx_dxc[j] + dxy * dy_dxc[j]) for j in range(3)], dim=-1)  # (F,K,3)
    dv_dxc = torch.stack([fy * (dyx * dx_dxc[j] + dyy * dy_dxc[j]) for j in range(3)], dim=-1)
    # xc = R(rvec) X + t: d xc / d rvec_k = dR[..., k] X, d xc / d t = I
    dxc_drv = torch.einsum("fijk,fpj->fpik", so3_exp_jacobian(pose[:, :3]), obj_pts)  # (F,K,3,3)
    duv_dxc = torch.stack([du_dxc, dv_dxc], dim=2)  # (F,K,2,3)
    dpose = torch.cat([torch.einsum("fkri,fkij->fkrj", duv_dxc, dxc_drv), duv_dxc], dim=-1)  # (F,K,2,6)
    dintr = torch.stack([torch.stack(pair, dim=-1) for pair in intr], dim=-1)  # (F,K,2,4+n_dist)
    m = mask[..., None, None]
    blocks = torch.zeros((F, Kc, 2, F, 6), dtype=params.dtype, device=params.device)
    frames = torch.arange(F, device=params.device)
    blocks[frames, :, :, frames] = dpose * m
    return torch.cat([dintr * m, blocks.reshape(F, Kc, 2, 6 * F)], dim=-1).reshape(F * Kc * 2, -1)


def _lm_refine(params0, obj_pts, img_pts, mask, n_dist, fisheye, fix_aspect, max_iter=300, robust_f=0.0):
    """LM over K + dist + per-frame poses; robust_f > 0 enables soft_l1 IRLS
    at that pixel scale (scipy least_squares convention: weighted residual
    r * (1 + |r|^2/f^2)^(-1/4), robust cost f^2 * 2(sqrt(1+z) - 1)), which
    downweights gross snap outliers without discarding edge coverage.
    robust_f = 0 keeps the exact quadratic cost (cv2.calibrateCamera parity).

    Returns (params, cost, iterations, converged, host reads).
    """
    dt = params0.dtype
    robust = robust_f > 0
    f2 = robust_f**2 if robust else 1.0

    # Frames with <4 valid corners (incl. all-masked padding frames from the
    # shape-bucketed caller) contribute zero residual rows, leaving their six
    # pose parameters unconstrained; a unit prior on exactly those diagonal
    # entries keeps the normal equations well-conditioned while their updates
    # stay zero (their gradient is zero).
    frame_ok = (mask.sum(dim=1) >= 4).to(dt)
    prior = torch.cat(
        [torch.zeros(4 + n_dist, dtype=dt, device=params0.device), torch.repeat_interleave(1.0 - frame_ok, 6)]
    )

    def point_z(p):
        r = _residuals(p, obj_pts, img_pts, mask, n_dist, fisheye, fix_aspect)
        return r, torch.sum(r**2, dim=-1) / f2  # (F,K)

    def cost_fn(p):
        r, z = point_z(p)
        if robust:
            return torch.sum(f2 * (torch.sqrt(1.0 + z) - 1.0))
        return 0.5 * torch.sum(r**2)

    p = params0
    lam = torch.tensor(1e-3, dtype=dt, device=p.device)
    cost = cost_fn(p)
    it, done, reads = 0, False, 0
    while it < max_iter and not done:
        r_pts, z = point_z(p)
        w = ((1.0 + z) ** -0.25 if robust else torch.ones_like(z))[..., None]  # (F,K,1)
        r = (r_pts * w).reshape(-1)
        J = _jacobian(p, obj_pts, mask, n_dist, fisheye, fix_aspect) * torch.broadcast_to(w, r_pts.shape).reshape(-1)[:, None]
        g = J.T @ r
        H = J.T @ J
        D = torch.clamp(torch.diagonal(H), min=1e-9)
        step, _ = torch.linalg.solve_ex(H + torch.diag(lam * D) + torch.diag(prior), g)
        p_new = p - step
        cost_new = cost_fn(p_new)
        accept = cost_new < cost
        lam = torch.clamp(torch.where(accept, lam * 0.35, lam * 4.0), 1e-12, 1e8)
        p = torch.where(accept, p_new, p)
        rel = (cost - cost_new) / torch.clamp(cost, min=1e-30)
        done_t = accept & (rel < 1e-10)
        cost = torch.where(accept, cost_new, cost)
        it += 1
        done = bool(done_t)  # the one device->host read of the iteration
        reads += 1
    return p, cost, it, done, reads


def _initial_params(K0, H, n_dist: int):
    """[fx, fy, cx, cy, 0 * n_dist] + per-frame poses from K0^-1 H."""
    F = H.shape[0]
    Hn = torch.linalg.solve(K0[None].expand(F, 3, 3), H)
    rvec0, tvec0 = pose_from_homography(Hn)
    return torch.cat(
        [
            torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
            torch.zeros(n_dist, dtype=K0.dtype, device=K0.device),
            torch.cat([rvec0, tvec0], dim=1).reshape(-1),
        ]
    )


def solve_intrinsics(
    obj_pts: np.ndarray,
    img_pts: np.ndarray,
    mask: np.ndarray,
    image_size: tuple[int, int],
    *,
    fisheye: bool = False,
    fix_aspect: bool = False,
    max_iter: int = 300,  # real sessions need ~120 LM iterations (60 truncated mid-descent)
    f_scale_px: float | None = None,
    device=None,
    dtype=None,
) -> IntrinsicSolveResult:
    """Calibrate K + distortion + per-frame poses from planar-target frames.

    Args:
        obj_pts: (F, K, 3) board-frame corner coords per frame (padded).
        img_pts: (F, K, 2) pixel observations (padded).
        mask:    (F, K) validity.
        image_size: (width, height) for the principal-point fallback.
        fisheye: equidistant 4-coef model instead of Brown 5-coef.
        f_scale_px: soft_l1 scale in pixels for robust refinement; None keeps
            the quadratic loss (cv2.calibrateCamera parity). The reported
            rmse is always the raw (unweighted) convention either way.
        device: CUDA unless given (e.g. "cpu"); raises without a CUDA device.
        dtype: float64 unless given, on CUDA too (see the module docstring).

    Matches cv2.calibrateCamera's CALIB_USE_INTRINSIC_GUESS-from-Zhang
    behavior and RMSE convention (sqrt of mean squared point error).
    """
    started = time.perf_counter()
    dev = resolve_device(device)
    dt = torch.float64 if dtype is None else dtype
    # Bucket (frames, corners) to powers of two as the JAX package does, so
    # padded shapes (and results) match it. All-masked padding frames are
    # inert — zero residual rows plus the unit pose prior in _lm_refine.
    F_real, K_real = int(np.asarray(obj_pts).shape[0]), int(np.asarray(obj_pts).shape[1])
    Fb, Kb = bucket_size(F_real, floor=8), bucket_size(K_real, floor=8)
    obj_b = np.zeros((Fb, Kb, 3))
    obj_b[:F_real, :K_real] = obj_pts
    img_b = np.zeros((Fb, Kb, 2))
    img_b[:F_real, :K_real] = img_pts
    m_b = np.zeros((Fb, Kb), bool)
    m_b[:F_real, :K_real] = mask
    obj = torch.as_tensor(obj_b, dtype=dt, device=dev)
    img = torch.as_tensor(img_b, dtype=dt, device=dev)
    m = torch.as_tensor(m_b, device=dev)
    mf = m.to(dt)
    n_dist = 4 if fisheye else 5

    # 1. Batched homographies board-plane -> pixels
    H = homography_dlt(obj[..., :2], img, m)
    frame_ok = m.sum(dim=1) >= 4
    # padding/degenerate frames: a finite placeholder H keeps the pose init
    # NaN-free; their poses are inert in the LM either way
    H = torch.where(frame_ok[:, None, None], H, torch.eye(3, dtype=dt, device=dev))

    # 2. Zhang closed-form K (fallback: f = 0.8 width, centered pp)
    K0 = zhang_intrinsics_from_homographies(H, frame_ok)
    w, h = image_size
    bad = torch.isnan(K0).any() | (K0[0, 0] <= 0) | (K0[0, 0] > 50 * w) | (K0[1, 1] <= 0)
    K_fallback = torch.tensor([[0.8 * w, 0, w / 2.0], [0, 0.8 * w, h / 2.0], [0, 0, 1.0]], dtype=dt, device=dev)
    K0 = torch.where(bad, K_fallback, K0)

    # 3. Per-frame pose init from K^-1 H; 4. joint LM
    robust_f = 0.0 if f_scale_px is None else float(f_scale_px)
    p, cost, it, done, reads = _lm_refine(
        _initial_params(K0, H, n_dist), obj, img, mf, n_dist, fisheye, fix_aspect, max_iter, robust_f=robust_f
    )

    def plausible(params) -> bool:
        fx_, fy_, cx_, cy_ = (float(x) for x in params[:4].cpu().numpy())
        return 0.1 * w <= fx_ <= 20 * w and 0.1 * w <= fy_ <= 20 * w and -0.5 * w <= cx_ <= 1.5 * w and -0.5 * h <= cy_ <= 1.5 * h

    restarted = False
    reads += 1
    if not plausible(p):
        # Orientation-poor planar sessions admit absurd low-focal minima the
        # Zhang init can fall into; restart from the neutral fallback
        # intrinsics and keep whichever solution is physical (lower cost
        # breaks a tie between two physical solutions).
        restarted = True
        p2, cost2, it2, done2, reads2 = _lm_refine(
            _initial_params(K_fallback, H, n_dist), obj, img, mf, n_dist, fisheye, fix_aspect, max_iter, robust_f=robust_f
        )
        reads += reads2 + 1
        keep_restart = plausible(p2)
        if not keep_restart:
            reads += 2
            keep_restart = float(cost2) < float(cost)
        if keep_restart:
            p, cost, it, done = p2, cost2, it2, done2

    r = _residuals(p, obj, img, mf, n_dist, fisheye, fix_aspect).cpu().numpy()
    n_obs = int(m_b.sum())
    rmse = float(np.sqrt(np.sum(r**2) / max(n_obs, 1)))
    reads += 2

    p = p.cpu().numpy().astype(np.float64)
    K = np.array([[p[0], 0, p[2]], [0, p[0] if fix_aspect else p[1], p[3]], [0, 0, 1.0]])
    pose = p[4 + n_dist :].reshape(-1, 6)[:F_real]
    return IntrinsicSolveResult(
        K=K,
        dist=p[4 : 4 + n_dist].copy(),
        rvecs=pose[:, :3].copy(),
        tvecs=pose[:, 3:].copy(),
        rmse=rmse,
        n_frames=F_real,
        converged=bool(done),
        n_iterations=int(it),
        restarted=restarted,
        host_reads=reads,
        n_frames_bucketed=Fb,
        seconds=time.perf_counter() - started,
    )
