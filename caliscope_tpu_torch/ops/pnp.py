"""Batched PnP (camera-to-object resection) on torch tensors.

Port of caliscope_tpu/ops/pnp.py. Every (camera, sync, object) group solves
in one batched call on padded blocks:

  init  — planar: normalized-DLT homography -> pose-from-homography;
          non-planar: 11-parameter DLT of the projection matrix;
          both branches are computed and the planarity mask selects.
  refine— damped Gauss-Newton on normalized reprojection, a fixed 12
          iterations, both planar lobes (IPPE's two-fold ambiguity) as one
          batch.

Where the JAX package differentiates the residuals with `jax.jacfwd` inside
a vmapped `fori_loop`, the port writes the Jacobian of `project_normalized`
with respect to (rvec, t) in closed form from `so3_exp_jacobian`
(tests/test_torch_pnp.py pins it to `jax.jacfwd` in float64). The batched
6x6 solves are `torch.linalg.solve_ex`, which never synchronises; the
symmetric eigensolves go through `_eigh_batched` (cuSOLVER's batch limit),
and they and the SVDs check cuSOLVER's status on the host, one device->host
synchronisation each.

All inputs are in normalized undistorted coordinates (K = I). Eigenvector
and singular-vector signs differ between LAPACK builds; every output here
is sign-free (a homography divided by H[2,2], a projection matrix scaled to
positive depth, an orthonormalized rotation), so the two packages' poses
agree while their intermediates need not.
"""

from __future__ import annotations

import math

import torch

from caliscope_tpu_torch.ops.lie import so3_exp, so3_exp_jacobian, so3_log
from caliscope_tpu_torch.ops.projection import _clamp_depth, project_normalized
from caliscope_tpu_torch.ops.triangulate import _eigh_batched


def _solve(A, b):
    """Batched linear solve without a host synchronisation (a singular
    system gives inf/NaN, as the JAX package's LU solve does)."""
    return torch.linalg.solve_ex(A, b)[0]


def _det3(M):
    """Determinant of (..., 3, 3) in closed form (no solver status check)."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _hartley_normalize(pts, mask):
    """Similarity-normalize 2D points to zero mean / sqrt(2) RMS. Returns
    (pts_norm, T (3,3)) with homogeneous transform T mapping raw -> norm."""
    w = mask.to(pts.dtype)[..., None]
    n = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
    mean = torch.sum(pts * w, dim=-2, keepdim=True) / n
    centered = (pts - mean) * w
    rms = torch.sqrt(torch.clamp(torch.sum(centered * centered, dim=(-2, -1), keepdim=True) / n, min=1e-18))
    s = math.sqrt(2.0) / rms[..., 0]
    pts_n = centered * s[..., None, :]
    sx = s[..., 0]
    zero, one = torch.zeros_like(sx), torch.ones_like(sx)
    T = torch.stack(
        [
            torch.stack([sx, zero, -sx * mean[..., 0, 0]], dim=-1),
            torch.stack([zero, sx, -sx * mean[..., 0, 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return pts_n, T


def homography_dlt(src, dst, mask):
    """Masked planar homography via normalized DLT.

    src, dst: (..., K, 2); mask: (..., K). Returns H (..., 3, 3) with
    dst ~ H @ src (homogeneous).
    """
    src_n, T_s = _hartley_normalize(src, mask)
    dst_n, T_d = _hartley_normalize(dst, mask)
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    # rows: [-x,-y,-1, 0,0,0, ux,uy,u] and [0,0,0, -x,-y,-1, vx,vy,v]
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([mask, mask], dim=-1).to(src.dtype)[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = _eigh_batched(AtA)
    Hn = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    # Denormalize: H = T_d^-1 Hn T_s
    H = _solve(T_d, Hn @ T_s)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)


def _orthonormalize(M):
    """Nearest rotation matrix (SVD, det +1)."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.sign(_det3(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * D[..., None, :]) @ Vt


def pose_from_homography(H):
    """H maps object-plane (x, y, 1) -> normalized image coords; recover
    (rvec, tvec) with R = [r1 r2 r1xr2] orthonormalized (Zhang 2000)."""
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 2.0 / torch.clamp(torch.linalg.vector_norm(h1, dim=-1) + torch.linalg.vector_norm(h2, dim=-1), min=1e-12)
    # the object must sit in front of the camera: flip if the depth is negative
    lam = lam * torch.where(h3[..., 2] * lam < 0, -1.0, 1.0)
    r1 = h1 * lam[..., None]
    r2 = h2 * lam[..., None]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = _orthonormalize(torch.stack([r1, r2, r3], dim=-1))
    t = h3 * lam[..., None]
    return so3_log(R), t


def projection_dlt(obj_pts, img_xn, mask):
    """Non-planar init: DLT for the 3x4 projection matrix P with
    img ~ P @ [X;1], then factor P -> (rvec, t). Needs >= 6 points."""
    X, Y, Z = obj_pts[..., 0], obj_pts[..., 1], obj_pts[..., 2]
    u, v = img_xn[..., 0], img_xn[..., 1]
    zero = torch.zeros_like(X)
    one = torch.ones_like(X)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([mask, mask], dim=-1).to(obj_pts.dtype)[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = _eigh_batched(AtA)
    P = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 4)
    # scale/sign: ||third row of R|| = 1 and mean depth positive
    scale = 1.0 / torch.clamp(torch.linalg.vector_norm(P[..., 2, :3], dim=-1), min=1e-12)
    w = mask.to(obj_pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean_obj = torch.sum(obj_pts * w[..., None], dim=-2) / n[..., None]
    depth = torch.einsum("...j,...j->...", P[..., 2, :3], mean_obj) + P[..., 2, 3]
    sign = torch.where(depth * scale < 0, -1.0, 1.0)
    P = P * (scale * sign)[..., None, None]
    R = _orthonormalize(P[..., :3, :3])
    return so3_log(R), P[..., :3, 3]


def project_normalized_jacobian(X, theta, min_depth: float = 1e-6):
    """(uv, d uv / d theta) of project_normalized(X, theta[:3], theta[3:]).

    X (B, K, 3), theta (B, 6) -> uv (B, K, 2), J (B, K, 2, 6). Closed form:
    d xc / d rvec from so3_exp_jacobian, d xc / d t = I, and the quotient
    rule through the clamped depth, whose derivative is 0 where the clamp
    holds (as forward-mode autodiff of the JAX package's `where` gives)."""
    rvec, t = theta[:, :3], theta[:, 3:]
    R = so3_exp(rvec)
    dR = so3_exp_jacobian(rvec)  # (B,3,3,3): [b, i, j, k] = dR_ij / d rvec_k
    xc = torch.einsum("bij,bnj->bni", R, X) + t[:, None, :]
    z = xc[..., 2]
    zc = _clamp_depth(z, min_depth)
    free = (torch.abs(z) >= min_depth).to(X.dtype)
    uv = xc[..., :2] / zc[..., None]
    d_rot = torch.einsum("bijk,bnj->bnik", dR, X)  # (B,K,3,3): d xc_i / d rvec_k
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(*d_rot.shape)
    dxc = torch.cat([d_rot, eye], dim=-1)  # (B,K,3,6)
    dz = dxc[..., 2, :] * free[..., None]
    J = (dxc[..., :2, :] - uv[..., :, None] * dz[..., None, :]) / zc[..., None, None]
    return uv, J


def refine_pose_gn(obj_pts, img_xn, mask, rvec0, tvec0, iters: int = 12, damping: float = 1e-6):
    """Damped Gauss-Newton refinement of (rvec, t) on normalized reprojection.

    Batched over leading axes (or one group with none); fixed iteration
    count. `mask` is a validity mask or a float weight per point."""
    theta0 = torch.cat([rvec0, tvec0], dim=-1)
    theta = theta0.reshape(-1, 6)
    X = obj_pts.reshape(-1, *obj_pts.shape[-2:])
    img = img_xn.reshape(-1, *img_xn.shape[-2:])
    w = mask.to(obj_pts.dtype).reshape(-1, mask.shape[-1])[..., None]
    eye = damping * torch.eye(6, dtype=theta.dtype, device=theta.device)
    for _ in range(iters):
        uv, J = project_normalized_jacobian(X, theta)
        r = (uv - img) * w
        J = J * w[..., None]
        JtJ = torch.einsum("bkci,bkcj->bij", J, J) + eye
        g = torch.einsum("bkci,bkc->bi", J, r)
        theta = theta - _solve(JtJ, g[..., None])[..., 0]
    return theta.reshape(theta0.shape)


def solve_pnp_batch(obj_pts, img_xn, mask, planar_tol: float = 1e-6, iters: int = 12):
    """Solve PnP for a batch of groups.

    Args:
        obj_pts: (G, K, 3) object-frame points (padded).
        img_xn:  (G, K, 2) normalized undistorted observations.
        mask:    (G, K) validity.

    Returns rvec (G,3), tvec (G,3), rms (G,) masked normalized reprojection
    RMSE, n_points (G,).

    A group is planar when the smallest eigenvalue of its centred scatter is
    below planar_tol times the largest (boards lie in z = 0; a two-sided
    board's back face at z = thickness makes a group non-planar, which then
    takes the DLT branch).
    """
    w = mask.to(obj_pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = torch.sum(obj_pts * w[..., None], dim=-2) / n[..., None]
    centered = (obj_pts - mean[..., None, :]) * w[..., None]
    scatter = torch.einsum("...ki,...kj->...ij", centered, centered)
    eigvals, eigvecs = _eigh_batched(scatter)
    planar = eigvals[..., 0] < planar_tol * torch.clamp(eigvals[..., 2], min=1e-12)

    # Planar branch, in the plane's own frame: the scatter's two principal
    # axes span it (their signs are arbitrary; the basis below is
    # right-handed either way, so the object-frame pose is not)
    axes = eigvecs[..., :, 1:]  # (G,3,2)
    plane_xy = torch.einsum("...kj,...ji->...ki", centered, axes)
    H = homography_dlt(plane_xy, img_xn, mask)
    rvec_p, t_p = pose_from_homography(H)
    # back to the object frame: x_plane = axes^T (X_obj - mean)
    R_plane = so3_exp(rvec_p)
    normal = torch.linalg.cross(axes[..., :, 0], axes[..., :, 1], dim=-1)
    basis = torch.cat([axes, normal[..., :, None]], dim=-1)  # plane -> object
    R_obj_p = R_plane @ basis.transpose(-1, -2)
    t_obj_p = t_p - torch.einsum("...ij,...j->...i", R_obj_p, mean)
    rvec_planar = so3_log(_orthonormalize(R_obj_p))

    rvec_np, t_np = projection_dlt(obj_pts, img_xn, mask)

    rvec0 = torch.where(planar[..., None], rvec_planar, rvec_np)
    tvec0 = torch.where(planar[..., None], t_obj_p, t_np)

    # Planar two-fold (IPPE) ambiguity: the second pose's plane normal is the
    # first's reflected about the line of sight (Schweighofer & Pinz).
    # Refine both lobes and keep the lower-error optimum.
    R0 = so3_exp(rvec0)
    n_cam = R0[..., :, 2]  # plane normal in the camera frame (object e_z)
    c_cam = tvec0 + torch.einsum("...ij,...j->...i", R0, mean)  # object centroid
    v_hat = c_cam / torch.clamp(torch.linalg.vector_norm(c_cam, dim=-1, keepdim=True), min=1e-9)
    n_ref = 2.0 * torch.sum(n_cam * v_hat, dim=-1, keepdim=True) * v_hat - n_cam
    axis = torch.linalg.cross(n_cam, n_ref, dim=-1)
    sin_a = torch.linalg.vector_norm(axis, dim=-1)
    cos_a = torch.clamp(torch.sum(n_cam * n_ref, dim=-1), -1.0, 1.0)
    ang = torch.atan2(sin_a, cos_a)
    axis_u = axis / torch.clamp(sin_a[..., None], min=1e-9)
    rvec0_b = so3_log(so3_exp(axis_u * ang[..., None]) @ R0)

    # both lobes in one batch of 2G groups
    two = lambda a: torch.cat([a, a], dim=0)  # noqa: E731
    th = refine_pose_gn(
        two(obj_pts), two(img_xn), two(mask), torch.cat([rvec0, rvec0_b]), torch.cat([tvec0, tvec0]), iters=iters
    )
    uv = project_normalized(two(obj_pts), th[..., None, :3], th[..., None, 3:])
    err2 = torch.sum((uv - two(img_xn)) ** 2, dim=-1) * two(w)
    rms2 = torch.sqrt(torch.sum(err2, dim=-1) / two(n))
    G = obj_pts.shape[0]
    theta_a, theta_b, rms_a, rms_b = th[:G], th[G:], rms2[:G], rms2[G:]
    use_b = planar & (rms_b < rms_a)
    theta = torch.where(use_b[..., None], theta_b, theta_a)
    rms = torch.where(use_b, rms_b, rms_a)
    return theta[..., :3], theta[..., 3:], rms, torch.sum(mask, dim=-1)
