"""Batched DLT triangulation (fixed-width, masked) on torch tensors.

Port of caliscope_tpu/ops/triangulate.py: every 3D point is triangulated
from a fixed-width (max_views) padded block of normalized observations with
a validity mask. Masked rows contribute zero rows to the DLT system, so one
batched `eigh` handles every grouping.
"""

from __future__ import annotations

import torch

# cuSOLVER's batched symmetric eigensolver (behind torch.linalg.eigh on CUDA)
# refuses batches of 32,768 matrices and more with CUSOLVER_STATUS_INVALID_VALUE
# (measured with torch 2.11 / CUDA 12.8 on an H100); 16,384 works.
EIGH_BATCH = 16_384


def _eigh_batched(M):
    """torch.linalg.eigh over (..., n, n) in chunks of EIGH_BATCH matrices."""
    flat = M.reshape(-1, *M.shape[-2:])
    parts = [torch.linalg.eigh(flat[i : i + EIGH_BATCH]) for i in range(0, max(flat.shape[0], 1), EIGH_BATCH)]
    w = torch.cat([p[0] for p in parts]).reshape(*M.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(M.shape)
    return w, v


def triangulate_dlt(P, xn, mask, refine_iters: int = 2):
    """Triangulate one 3D point per batch row from padded multi-view obs.

    Args:
        P:    (..., V, 3, 4) normalized projection matrices [R|t] per view.
        xn:   (..., V, 2) undistorted normalized image coords per view.
        mask: (..., V) boolean validity per view.
        refine_iters: Gauss-Newton polish steps after the DLT.

    Returns (..., 3) points (garbage where < 2 valid views — callers filter
    with the view count).

    Method: rows [x*P2 - P0; y*P2 - P1] per view; the eigenvector of the
    smallest eigenvalue of A^T A, then Gauss-Newton steps on the
    reprojection objective. The polish absorbs the conditioning A^T A loses
    in float32 and lowers the reprojection error the reports measure.
    """
    x = xn[..., 0:1]
    y = xn[..., 1:2]
    P0, P1, P2 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    A = torch.cat([x * P2 - P0, y * P2 - P1], dim=-2)  # (...,2V,4)
    m = torch.cat([mask, mask], dim=-1).to(A.dtype)[..., None]
    A = A * m
    AtA = torch.einsum("...vi,...vj->...ij", A, A)
    _, vecs = _eigh_batched(AtA)
    h = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    w = h[..., 3:4]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    X = h[..., :3] / w

    mf = mask.to(A.dtype)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    for _ in range(refine_iters):
        q = torch.einsum("...vij,...j->...vi", P[..., :, :3], X) + P[..., :, 3]  # (...,V,3)
        z = q[..., 2]
        safe = torch.abs(z) > 1e-9
        inv_z = torch.where(safe, 1.0 / torch.where(safe, z, torch.ones_like(z)), torch.zeros_like(z))
        u = q[..., 0] * inv_z
        v = q[..., 1] * inv_z
        ru = (u - xn[..., 0]) * mf
        rv = (v - xn[..., 1]) * mf
        # d u / dX = (P0[:3] - u * P2[:3]) / z   (same for v with P1)
        Ju = (P[..., 0, :3] - u[..., None] * P[..., 2, :3]) * inv_z[..., None] * mf[..., None]
        Jv = (P[..., 1, :3] - v[..., None] * P[..., 2, :3]) * inv_z[..., None] * mf[..., None]
        g = torch.einsum("...vi,...v->...i", Ju, ru) + torch.einsum("...vi,...v->...i", Jv, rv)
        H = torch.einsum("...vi,...vj->...ij", Ju, Ju) + torch.einsum("...vi,...vj->...ij", Jv, Jv)
        H = H + 1e-9 * eye
        # closed-form 3x3 solve (batched adjugate; H is SPD + damped)
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
        c00 = d * f - e * e
        c01 = c * e - b * f
        c02 = b * e - c * d
        c11 = a * f - c * c
        c12 = b * c - a * e
        c22 = a * d - b * b
        det = a * c00 + b * c01 + c * c02
        ok = torch.abs(det) > 1e-30
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
        step = torch.stack(
            [
                c00 * g[..., 0] + c01 * g[..., 1] + c02 * g[..., 2],
                c01 * g[..., 0] + c11 * g[..., 1] + c12 * g[..., 2],
                c02 * g[..., 0] + c12 * g[..., 1] + c22 * g[..., 2],
            ],
            dim=-1,
        ) * inv_det[..., None]
        X = X - step
    return X


def triangulate_groups(proj_mats, cam_idx, xn, point_idx, n_points: int, max_views: int):
    """Scatter flat observations into padded per-point view blocks, then DLT.

    Args:
        proj_mats: (C, 3, 4) normalized projection matrix per camera.
        cam_idx:   (N,) int camera index per observation.
        xn:        (N, 2) normalized undistorted coords per observation.
        point_idx: (N,) int 3D-point index per observation in [0, n_points).
        n_points:  number of 3D points.
        max_views: padding width (>= max cameras per point; extra views of a
                   point are dropped).

    Returns (xyz (n_points, 3), n_views (n_points,)). The slot of each
    observation within its point comes from a stable argsort, on the device.
    """
    N = cam_idx.shape[0]
    dev = cam_idx.device
    order = torch.argsort(point_idx, stable=True)
    sorted_pt = point_idx[order]
    pos = torch.arange(N, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sorted_pt[1:] != sorted_pt[:-1]])
    group_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), dim=0).values
    slot = pos - group_start
    valid = slot < max_views
    dest_pt = torch.where(valid, sorted_pt, torch.full_like(sorted_pt, n_points))  # overflow rows dropped
    dest_slot = torch.where(valid, slot, torch.zeros_like(slot))
    xn_pad = torch.zeros((n_points + 1, max_views, 2), dtype=xn.dtype, device=dev)
    cam_pad = torch.zeros((n_points + 1, max_views), dtype=cam_idx.dtype, device=dev)
    mask_pad = torch.zeros((n_points + 1, max_views), dtype=torch.bool, device=dev)
    xn_pad[dest_pt, dest_slot] = xn[order]
    cam_pad[dest_pt, dest_slot] = cam_idx[order]
    mask_pad[dest_pt, dest_slot] = valid
    xn_pad, cam_pad, mask_pad = xn_pad[:-1], cam_pad[:-1], mask_pad[:-1]
    xyz = triangulate_dlt(proj_mats[cam_pad], xn_pad, mask_pad)
    return xyz, mask_pad.sum(-1)
