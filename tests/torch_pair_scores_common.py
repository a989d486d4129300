"""The port's single-pair stereo score as it was before the batched pass
(caliscope_tpu_torch/solvers/pose_network.py::stereo_rmse_batch): two
point_index() calls, the pair's rows undistorted with camera A's model
flag, triangulate_groups(max_views=2) on the device, the reprojection in
float64 numpy. The tests and the card's check hold the batch to it pair by
pair. Imports nothing of the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.ops.bucket import bucket_size, pad_rows
from caliscope_tpu_torch.ops.projection import undistort_points
from caliscope_tpu_torch.ops.triangulate import triangulate_groups


def per_pair_stereo_rmse(pair, image_points, camera_array, device=None) -> float:
    device = resolve_device(device)
    dtype = resolve_dtype(device)

    def to(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dt)

    a, b = pair.primary_cam_id, pair.secondary_cam_id
    cam_a, cam_b = camera_array.cameras[a], camera_array.cameras[b]
    ip = image_points.select(np.isin(image_points.cam_id, [a, b]))
    if len(ip) == 0:
        return np.nan
    pt_idx, _keys = ip.point_index()
    seen_a = np.zeros(pt_idx.max() + 1, bool)
    seen_b = np.zeros(pt_idx.max() + 1, bool)
    seen_a[pt_idx[ip.cam_id == a]] = True
    seen_b[pt_idx[ip.cam_id == b]] = True
    ip = ip.select((seen_a & seen_b)[pt_idx])
    if len(ip) < 10:
        return np.nan
    pt_idx, _ = ip.point_index()

    is_a = ip.cam_id == a
    K = np.where(is_a[:, None, None], cam_a.matrix[None], cam_b.matrix[None])
    dmax = max(len(cam_a.distortions), len(cam_b.distortions))
    da = np.zeros(dmax)
    da[: len(cam_a.distortions)] = cam_a.distortions
    db = np.zeros(dmax)
    db[: len(cam_b.distortions)] = cam_b.distortions
    d = np.where(is_a[:, None], da[None], db[None])
    N = len(ip)
    Nb = bucket_size(N)
    n_points = int(pt_idx.max()) + 1
    Pb = bucket_size(n_points + 1)
    K_b = pad_rows(K, Nb)
    K_b[N:] = np.eye(3)
    xn_dev = undistort_points(to(pad_rows(ip.img_xy, Nb)), to(K_b), to(pad_rows(d, Nb)), cam_a.fisheye)

    proj = np.zeros((2, 3, 4))
    proj[0, :3, :3] = np.eye(3)
    proj[1, :3, :3] = pair.rotation
    proj[1, :3, 3] = pair.translation
    cam_idx = np.where(is_a, 0, 1)
    xyz, n_views = triangulate_groups(
        to(proj), to(pad_rows(cam_idx, Nb), torch.int64), xn_dev, to(pad_rows(pt_idx, Nb, fill=Pb - 1), torch.int64), Pb, 2
    )
    xn = xn_dev[:N].cpu().numpy().astype(np.float64)
    xyz = xyz[:n_points].cpu().numpy().astype(np.float64)
    n_views = n_views[:n_points].cpu().numpy()
    P = proj[cam_idx]
    Xh = np.concatenate([xyz[pt_idx], np.ones((len(ip), 1))], axis=1)
    xc = np.einsum("nij,nj->ni", P, Xh)
    ok = xc[:, 2] > 1e-6
    uvn = xc[:, :2] / np.where(ok, xc[:, 2], 1.0)[:, None]
    f = np.where(is_a, cam_a.matrix[0, 0], cam_b.matrix[0, 0])
    err_px = np.linalg.norm(uvn - xn, axis=1) * f
    err_px = err_px[ok & (n_views[pt_idx] >= 2)]
    if len(err_px) == 0:
        return np.nan
    return float(np.sqrt(np.mean(err_px**2)))
