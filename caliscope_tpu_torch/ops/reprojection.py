"""Reprojection residuals, their Jacobian blocks, and distance-constraint rows.

Port of caliscope_tpu/ops/reprojection.py: the dense point-minor layout
(C, P), the sparse rows obs-minor (2, N) and row-major (N, 2), and the
constraint rows with their analytic blocks.

Camera parameter block layout:
    cam9 = [rvec(3), tvec(3), s, k1, k2]
with fx = s * fx_init, fy = s * fy_init and [k1, k2] replacing the first two
distortion coefficients; the remaining coefficients stay at their initial
values. Residuals are pixel errors scaled by 1/fx_init per camera.

The JAX package builds the Jacobian blocks with `jacfwd` under `vmap`. Here
they are closed forms: the chain rule through the projection written out
once, elementwise (`_projection_terms`), and fed either (C, P) tensors —
per-camera quantities (R, dR/drvec, intrinsics) as (C, 1) columns, per-point
ones along the minor P axis — or (N,) lanes with the per-camera quantities
gathered per observation, so one LM iteration's blocks are a few dozen
elementwise launches and no per-point autodiff. The row-major blocks are the
obs-minor ones transposed. tests/test_torch_ops.py and
tests/test_torch_bundle_sparse.py pin them to the JAX package's blocks in
float64.
"""

from __future__ import annotations

import torch

from caliscope_tpu_torch.ops.lie import so3_exp, so3_exp_jacobian
from caliscope_tpu_torch.ops.projection import _clamp_depth, project_points

N_CAM_PARAMS = 9  # 6 extrinsic + [s, k1, k2]


def camera_matrices_from_block(cam9, K0):
    """cam9 (..., 9) + initial K0 (..., 3, 3) -> effective K (..., 3, 3)."""
    K = K0.clone()
    K[..., 0, 0] = K0[..., 0, 0] * cam9[..., 6]
    K[..., 1, 1] = K0[..., 1, 1] * cam9[..., 6]
    return K


def effective_distortions(cam9, dist0):
    """Replace the first two coefficients with the free [k1, k2]."""
    d = dist0.clone()
    d[..., 0] = cam9[..., 7]
    d[..., 1] = cam9[..., 8]
    return d


def project_with_block(X, cam9, K0, dist0, fisheye_flag, any_fisheye: bool = True):
    """Project world point(s) X through the 9-parameter camera block.

    Both camera models are evaluated and selected by the fisheye_flag
    tensor, so mixed rigs batch in one call; `any_fisheye=False` (all-Brown
    rigs) skips the fisheye model."""
    K = camera_matrices_from_block(cam9, K0)
    dist = effective_distortions(cam9, dist0)
    uv_brown = project_points(X, cam9[..., 0:3], cam9[..., 3:6], K, dist, False)
    if not any_fisheye:
        return uv_brown
    uv_fish = project_points(X, cam9[..., 0:3], cam9[..., 3:6], K, dist[..., :4], True)
    return torch.where(fisheye_flag[..., None], uv_fish, uv_brown)


def _projection_terms(xc0, xc1, xc2, s, k1, k2, fx0, fy0, cx, cy, d2, d3, d4, fe, jac: bool):
    """Pixel projection of camera-frame points on the effective intrinsics,
    elementwise: every argument broadcasts against the others (per-camera
    (C, 1) columns against (C, P) grids in the dense layout, (N,) lanes in
    the sparse ones). fe is the per-camera fisheye flag broadcast the same
    way, or None for an all-Brown rig.

    Returns (u, v) and, with jac=True, the chain rule's pieces as lists of
    tensors: d(u, v)/d xc (two lists of 3) and d(u, v)/d(s, k1, k2) (two
    lists of 3)."""
    fx, fy = fx0 * s, fy0 * s
    z = _clamp_depth(xc2, 1e-6)
    x = xc0 / z
    y = xc1 / z
    r2 = x * x + y * y
    # Brown-Conrady on the effective coefficients [k1, k2, d2, d3, d4]
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * d4))
    xd = x * radial + 2.0 * d2 * x * y + d3 * (r2 + 2.0 * x * x)
    yd = y * radial + d2 * (r2 + 2.0 * y * y) + 2.0 * d3 * x * y
    if jac:
        drad = k1 + r2 * (2.0 * k2 + 3.0 * d4 * r2)  # d radial / d r2
        dxx = radial + 2.0 * x * x * drad + 2.0 * d2 * y + 6.0 * d3 * x
        dxy = 2.0 * x * y * drad + 2.0 * d2 * x + 2.0 * d3 * y  # = d yd / d x
        dyy = radial + 2.0 * y * y * drad + 6.0 * d2 * y + 2.0 * d3 * x
        dyx = dxy
        dxk1, dxk2 = x * r2, x * r2 * r2
        dyk1, dyk2 = y * r2, y * r2 * r2
    if fe is not None:
        # equidistant model on [k1, k2, d2, d3], selected per camera
        rn = torch.sqrt(torch.clamp(r2, min=1e-18))
        th = torch.atan(rn)
        t2 = th * th
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (d2 + t2 * d3)))
        thd = th * poly
        sc = thd / rn
        xd = torch.where(fe, x * sc, xd)
        yd = torch.where(fe, y * sc, yd)
        if jac:
            dthd = poly + 2.0 * t2 * (k1 + t2 * (2.0 * k2 + t2 * (3.0 * d2 + 4.0 * d3 * t2)))
            drn = torch.where(r2 > 1e-18, 0.5 / rn, torch.zeros_like(rn))  # d rn / d r2
            dsc = (dthd / (1.0 + rn * rn) / rn - thd / (rn * rn)) * drn  # d sc / d r2
            dxx = torch.where(fe, sc + 2.0 * x * x * dsc, dxx)
            dxy = torch.where(fe, 2.0 * x * y * dsc, dxy)
            dyx = torch.where(fe, 2.0 * x * y * dsc, dyx)
            dyy = torch.where(fe, sc + 2.0 * y * y * dsc, dyy)
            dxk1 = torch.where(fe, x * th * t2 / rn, dxk1)
            dxk2 = torch.where(fe, x * th * t2 * t2 / rn, dxk2)
            dyk1 = torch.where(fe, y * th * t2 / rn, dyk1)
            dyk2 = torch.where(fe, y * th * t2 * t2 / rn, dyk2)
    u = xd * fx + cx
    v = yd * fy + cy
    if not jac:
        return u, v
    inv_z = 1.0 / z
    dz = torch.where(torch.abs(xc2) < 1e-6, torch.zeros_like(z), inv_z)  # the clamp has no slope
    # d(x, y)/d xc: x = xc0/z, y = xc1/z
    zero = torch.zeros_like(x)
    dx_dxc = (inv_z, zero, -x * dz)
    dy_dxc = (zero, inv_z, -y * dz)
    du_dxc = [fx * (dxx * dx_dxc[j] + dxy * dy_dxc[j]) for j in range(3)]
    dv_dxc = [fy * (dyx * dx_dxc[j] + dyy * dy_dxc[j]) for j in range(3)]
    return u, v, (du_dxc, dv_dxc), ([xd * fx0, fx * dxk1, fx * dxk2], [yd * fy0, fy * dyk1, fy * dyk2])


def _dense_projection(cam9_all, X_all, K0_all, dist0_all, fisheye_all, any_fisheye: bool, jac: bool):
    """Pixel projection of every (camera, point) pair, point-minor (C, P).

    Returns (u, v) and, with jac=True, the pieces of the chain rule:
    d(u,v)/d xc as (C,2,3,P), d(u,v)/d(s,k1,k2) as (C,2,3,P), the rotations
    R (C,3,3) and dR/drvec (C,3,3,3)."""
    R = so3_exp(cam9_all[:, 0:3])  # (C,3,3)
    xc = torch.einsum("cij,pj->cip", R, X_all) + cam9_all[:, 3:6, None]  # (C,3,P)
    col = lambda a: a[:, None]  # noqa: E731  per-camera scalar -> (C,1)
    out = _projection_terms(
        xc[:, 0], xc[:, 1], xc[:, 2],
        col(cam9_all[:, 6]), col(cam9_all[:, 7]), col(cam9_all[:, 8]),
        col(K0_all[:, 0, 0]), col(K0_all[:, 1, 1]), col(K0_all[:, 0, 2]), col(K0_all[:, 1, 2]),
        col(dist0_all[:, 2]), col(dist0_all[:, 3]), col(dist0_all[:, 4]),
        fisheye_all[:, None] if any_fisheye else None, jac,
    )
    if not jac:
        return out
    u, v, (du_dxc, dv_dxc), (du_int, dv_int) = out
    J_xc = torch.stack([torch.stack(du_dxc, 1), torch.stack(dv_dxc, 1)], 1)  # (C,2,3,P)
    J_int = torch.stack([torch.stack(du_int, 1), torch.stack(dv_int, 1)], 1)  # (C,2,3,P)
    return u, v, J_xc, J_int, R, so3_exp_jacobian(cam9_all[:, 0:3])


def dense_observation_residuals(cam9_all, X_all, uv_t, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye: bool = True):
    """Residuals in the dense observation layout, point-minor.

    uv_t: (C, 2, P) pixels; returns (C, 2, P) in 1/fx_init units."""
    u, v = _dense_projection(cam9_all, X_all, K0_all, dist0_all, fisheye_all, any_fisheye, jac=False)
    return (torch.stack([u, v], 1) - uv_t) * inv_fx_all[:, None, None]


def dense_observation_jacobian_blocks(cam9_all, X_all, uv_t, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye: bool = True):
    """Jacobian blocks in the dense layout, point-minor.

    uv_t: (C, 2, P). Returns (r (C,2,P), Jc (C,2,9,P), Jp (C,2,3,P)) with
    Jc's columns [rvec, tvec, s, k1, k2]."""
    u, v, J_xc, J_int, R, dR = _dense_projection(
        cam9_all, X_all, K0_all, dist0_all, fisheye_all, any_fisheye, jac=True
    )
    ifx = inv_fx_all[:, None, None]
    r = (torch.stack([u, v], 1) - uv_t) * ifx
    # xc = R X + t: d xc/d t = I, d xc/d X = R, d xc/d rvec_k = dR[..., k] X
    # (contractions over the size-3 axis as broadcast products and sums: as
    # einsums they lower to batched 2x3 @ 3x3 matrix products, one per
    # (camera, point), which is the slowest way to run them on a GPU)
    dxc_drv = torch.einsum("cijk,pj->cikp", dR, X_all)  # (C,3,3,P)
    J_rv = (J_xc[:, :, :, None, :] * dxc_drv[:, None]).sum(2)  # (C,2,3,P)
    J_X = (J_xc[:, :, :, None, :] * R[:, None, :, :, None]).sum(2)
    Jc = torch.cat([J_rv, J_xc, J_int], 2) * ifx[..., None]
    # row-major (C,2,k,P), the layout the fused Schur kernel reads
    return r.contiguous(), Jc.contiguous(), (J_X * ifx[..., None]).contiguous()


def _lane_projection(cam9_all, X_all, cam_idx, pt_idx, K0_all, dist0_all, fisheye_all, any_fisheye: bool, jac: bool):
    """Pixel projection of every observation row, obs-minor (N,) lanes.

    Per-camera quantities (rotation and its tangents, intrinsics) are
    computed once per camera and gathered per lane. Returns (u, v) and,
    with jac=True, d(u,v)/d xc (2,3,N), d(u,v)/d(s,k1,k2) (2,3,N),
    d xc/d rvec (3,3,N) and R gathered per lane (3,3,N)."""
    ci, pi = cam_idx, pt_idx
    R_all = so3_exp(cam9_all[:, 0:3])  # (C,3,3)
    X = X_all[pi].T  # (3,N)
    Rg = R_all[ci].permute(1, 2, 0)  # (3,3,N)
    xc = (Rg * X[None]).sum(1) + cam9_all[:, 3:6][ci].T  # (3,N)
    lane = lambda a: a[ci]  # noqa: E731  per-camera scalar -> (N,)
    out = _projection_terms(
        xc[0], xc[1], xc[2],
        lane(cam9_all[:, 6]), lane(cam9_all[:, 7]), lane(cam9_all[:, 8]),
        lane(K0_all[:, 0, 0]), lane(K0_all[:, 1, 1]), lane(K0_all[:, 0, 2]), lane(K0_all[:, 1, 2]),
        lane(dist0_all[:, 2]), lane(dist0_all[:, 3]), lane(dist0_all[:, 4]),
        lane(fisheye_all) if any_fisheye else None, jac,
    )
    if not jac:
        return out
    u, v, (du_dxc, dv_dxc), (du_int, dv_int) = out
    J_xc = torch.stack([torch.stack(du_dxc), torch.stack(dv_dxc)])  # (2,3,N)
    J_int = torch.stack([torch.stack(du_int), torch.stack(dv_int)])  # (2,3,N)
    # d xc/d rvec_k = dR[..., k] X, per camera then gathered
    dR = so3_exp_jacobian(cam9_all[:, 0:3])[ci].permute(1, 2, 3, 0)  # (3,3,3,N)
    dxc_drv = (dR * X[None, :, None, :]).sum(1)  # (3,3,N) [i, k]
    return u, v, J_xc, J_int, dxc_drv, Rg


def observation_residuals_obs_minor(cam9_all, X_all, cam_idx, pt_idx, uv_t, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye: bool = True):
    """Residuals of observation rows, obs-minor (2, N) in 1/fx_init units;
    uv_t (2, N) pixels."""
    u, v = _lane_projection(cam9_all, X_all, cam_idx, pt_idx, K0_all, dist0_all, fisheye_all, any_fisheye, jac=False)
    return (torch.stack([u, v]) - uv_t) * inv_fx_all[cam_idx][None, :]


def observation_blocks_obs_minor(cam9_all, X_all, cam_idx, pt_idx, uv_t, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye: bool = True):
    """Jacobian blocks of observation rows, obs-minor: r (2,N), Jc (2,9,N)
    with columns [rvec, tvec, s, k1, k2], Jp (2,3,N). The same closed-form
    chain rule as the dense blocks, on lanes."""
    u, v, J_xc, J_int, dxc_drv, Rg = _lane_projection(
        cam9_all, X_all, cam_idx, pt_idx, K0_all, dist0_all, fisheye_all, any_fisheye, jac=True
    )
    ifx = inv_fx_all[cam_idx]  # (N,)
    r = (torch.stack([u, v]) - uv_t) * ifx
    J_rv = (J_xc[:, :, None, :] * dxc_drv[None]).sum(1)  # (2,3,N)
    J_X = (J_xc[:, :, None, :] * Rg[None]).sum(1)  # (2,3,N)
    Jc = torch.cat([J_rv, J_xc, J_int], 1) * ifx
    return r, Jc, J_X * ifx


def observation_residuals(cam9_all, X_all, cam_idx, pt_idx, uv, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye: bool = True):
    """Residuals of observation rows, row-major (N, 2) in 1/fx_init units."""
    return observation_residuals_obs_minor(
        cam9_all, X_all, cam_idx, pt_idx, uv.T, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye
    ).T.contiguous()


def observation_jacobian_blocks(cam9_all, X_all, cam_idx, pt_idx, uv, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye: bool = True):
    """Jacobian blocks of observation rows, row-major: r (N,2), Jc (N,2,9),
    Jp (N,2,3) — the obs-minor blocks transposed."""
    r, Jc, Jp = observation_blocks_obs_minor(
        cam9_all, X_all, cam_idx, pt_idx, uv.T, K0_all, dist0_all, fisheye_all, inv_fx_all, any_fisheye
    )
    return r.T.contiguous(), Jc.permute(2, 0, 1).contiguous(), Jp.permute(2, 0, 1).contiguous()


def reprojection_errors(cam9_all, X_all, cam_idx, pt_idx, uv, K0_all, dist0_all, fisheye_all):
    """Per-observation PIXEL-space errors (N, 2) for reports."""
    uv_hat = project_with_block(
        X_all[pt_idx], cam9_all[cam_idx], K0_all[cam_idx], dist0_all[cam_idx], fisheye_all[cam_idx]
    )
    return uv_hat - uv


def _endpoints(X_all, pa_idx, pa_w, pb_idx, pb_w):
    """Weighted endpoint means (Q,3) of both constraint ends."""
    pa = (pa_w[:, :, None] * X_all[pa_idx]).sum(1)
    pb = (pb_w[:, :, None] * X_all[pb_idx]).sum(1)
    return pa, pb


def constraint_residuals(X_all, pa_idx, pa_w, pb_idx, pb_w, target, weight):
    """Distance-constraint rows: (Q,) residuals weight * (||pa - pb|| -
    target), each endpoint the weighted mean of up to 4 world points (a
    corner is one point at weight 1, a marker centroid four at 0.25;
    padded slots carry weight 0)."""
    pa, pb = _endpoints(X_all, pa_idx, pa_w, pb_idx, pb_w)
    d = torch.sqrt(torch.clamp(torch.sum((pa - pb) ** 2, dim=-1), min=1e-18))
    return (d - target) * weight


def constraint_jacobian_blocks(X_all, pa_idx, pa_w, pb_idx, pb_w, target, weight):
    """Analytic constraint Jacobian blocks: d r / d pa = weight * (pa - pb) /
    ||pa - pb||, chained by the endpoint weights to each point. Returns
    (r (Q,), idx (Q,8), J (Q,8,3)), the 8 slots [4 x endpoint A, 4 x B]."""
    pa, pb = _endpoints(X_all, pa_idx, pa_w, pb_idx, pb_w)
    diff = pa - pb
    d = torch.sqrt(torch.clamp(torch.sum(diff**2, dim=-1), min=1e-18))
    r = (d - target) * weight
    u = diff / d[:, None]  # (Q,3) unit direction
    Ja = weight[:, None, None] * pa_w[:, :, None] * u[:, None, :]  # (Q,4,3)
    Jb = -weight[:, None, None] * pb_w[:, :, None] * u[:, None, :]
    return r, torch.cat([pa_idx, pb_idx], 1), torch.cat([Ja, Jb], 1)


def robust_weights_and_cost(r2_elements, loss: str, f_scale: float):
    """Per-element IRLS weights and total robust cost.

    scipy convention: cost = 0.5 * f_scale^2 * sum(rho(r^2 / f_scale^2));
    GN reweighting uses rho'(z). loss='linear' or 'soft_l1'."""
    if loss == "linear":
        return torch.ones_like(r2_elements), 0.5 * torch.sum(r2_elements)
    if loss == "soft_l1":
        z = r2_elements / (f_scale**2)
        rho = 2.0 * (torch.sqrt(1.0 + z) - 1.0)
        w = 1.0 / torch.sqrt(1.0 + z)  # rho'(z)
        return w, 0.5 * (f_scale**2) * torch.sum(rho)
    raise ValueError(f"Unknown loss: {loss}")
