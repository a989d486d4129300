"""Markerless (epipolar) pose bootstrap: essential matrix + scaffold resection.

Port of caliscope_tpu/solvers/epipolar.py. Used when observations carry no
obj_loc (markerless body-pose data): each pair's pooled 2D-2D
correspondences give an essential-matrix relative pose; one scaffold pair's
cloud anchors the rig and every other camera registers by resection; the
scaffold is chosen by third-view validation (how well OTHER cameras fit its
cloud), which catches wrong-but-self-consistent essential estimates near the
coplanarity degeneracy.

Device and host: the essential RANSACs, the pose recovery, the scaffold
triangulation and the resection RANSACs run on `device` (CUDA unless the
caller names another) in its default dtype; the joins and the small
scaffold-selection logic run on the host in numpy. The JAX package joins
observations through Python dicts row by row; here every join is one sort
and one binary search over (object, keypoint, sync) keys packed into one
int64, with the dict's semantics kept: camera b's row order, and the last
of duplicate keys.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.ops.bucket import bucket_size, pad_rows
from caliscope_tpu_torch.solvers.pose_network import PairedPoseNetwork, StereoPair, _on, stereo_rmse_batch

logger = logging.getLogger(__name__)

RANSAC_THRESHOLD_PX = 3.0  # pixel gate, converted per pair to normalized units
MIN_CORRESPONDENCES = 8
MIN_RESECTION_POINTS = 50
CONDITIONING_FLOOR = 0.5
MAX_SCAFFOLD_CANDIDATES = 12
ESSENTIAL_RANSAC_ITERS = 512
PNP_RANSAC_ITERS = 256


def _packed(*keysets: np.ndarray) -> list[np.ndarray]:
    """(N, 3) int key tables -> one int64 code per row, the same packing for
    every table: each column offset by its minimum over all of them (sync
    may be STATIC_SYNC_INDEX = -1) and scaled by the spans of the columns
    after it."""
    allk = np.concatenate([np.asarray(k, np.int64).reshape(-1, 3) for k in keysets])
    if len(allk) == 0:
        return [np.zeros(len(k), np.int64) for k in keysets]
    lo = allk.min(axis=0)
    span = allk.max(axis=0) - lo + 1
    if float(span[0]) * float(span[1]) * float(span[2]) >= 2.0**62:
        raise ValueError("observation keys span too wide a range to pack into one int64")
    return [((k[:, 0] - lo[0]) * span[1] + (k[:, 1] - lo[1])) * span[2] + (k[:, 2] - lo[2]) for k in keysets]


def _last_match(ref_codes: np.ndarray, query_codes: np.ndarray) -> np.ndarray:
    """For each query code, the index in ref_codes of its LAST occurrence
    (a dict built over ref keeps the last row of a key), -1 where absent."""
    if len(ref_codes) == 0:
        return np.full(len(query_codes), -1, np.int64)
    order = np.argsort(ref_codes, kind="stable")
    sorted_codes = ref_codes[order]
    last = np.ones(len(order), bool)
    last[:-1] = sorted_codes[1:] != sorted_codes[:-1]
    uniq, rows = sorted_codes[last], order[last]
    pos = np.searchsorted(uniq, query_codes)
    found = pos < len(uniq)
    found[found] = uniq[pos[found]] == query_codes[found]
    return np.where(found, rows[np.minimum(pos, len(uniq) - 1)], -1)


def _keys(ip: ImagePoints, rows: np.ndarray) -> np.ndarray:
    return np.stack([ip.object_id[rows], ip.keypoint_id[rows], ip.sync_index[rows]], axis=1)


def pooled_correspondences(ip: ImagePoints, cam_a: int, cam_b: int):
    """Matched pixels for one pair, pooled over every shared frame, in
    camera b's row order.

    Returns (keys (N,3) [obj, kp, sync], pix_a (N,2), pix_b (N,2)).
    """
    rows_a = np.flatnonzero(ip.cam_id == cam_a)
    rows_b = np.flatnonzero(ip.cam_id == cam_b)
    keys_a, keys_b = _keys(ip, rows_a), _keys(ip, rows_b)
    codes_a, codes_b = _packed(keys_a, keys_b)
    match = _last_match(codes_a, codes_b)
    hit = match >= 0
    if not hit.any():
        return np.empty((0, 3), np.int64), np.empty((0, 2)), np.empty((0, 2))
    keys = keys_b[hit]
    pa = ip.img_xy[rows_a[match[hit]]]
    pb = ip.img_xy[rows_b[hit]]
    finite = np.isfinite(pa).all(axis=1) & np.isfinite(pb).all(axis=1)
    return keys[finite], pa[finite], pb[finite]


def recover_pair_pose(pixels_a, pixels_b, *, camera_a: CameraData, camera_b: CameraData, seed: int = 0,
                      device=None) -> dict:
    """Essential relative pose of b w.r.t. a (unit baseline) from pixels,
    the RANSAC and the cheirality vote on `device`."""
    from caliscope_tpu_torch.ops.epipolar import essential_ransac, recover_pose

    device = resolve_device(device)
    to = _on(device, resolve_dtype(device))
    norm_a = camera_a.undistort_points(pixels_a, output="normalized")
    norm_b = camera_b.undistort_points(pixels_b, output="normalized")
    mean_focal = 0.5 * (camera_a.matrix[0, 0] + camera_b.matrix[0, 0])
    threshold = RANSAC_THRESHOLD_PX / mean_focal
    # correspondence rows bucketed as the JAX package buckets them
    N = len(norm_a)
    Nb = bucket_size(N)
    mask = np.zeros(Nb, bool)
    mask[:N] = True
    na_b, nb_b, mask_b = to(pad_rows(norm_a, Nb)), to(pad_rows(norm_b, Nb)), to(mask, torch.bool)
    E, inl, n_inl = essential_ransac(na_b, nb_b, mask_b, threshold, n_iters=ESSENTIAL_RANSAC_ITERS, seed=seed)
    if int(n_inl) < MIN_CORRESPONDENCES:
        raise ValueError(f"essential-matrix estimation degenerate ({int(n_inl)} inliers)")
    R, t, cheir = recover_pose(E, na_b, nb_b, inl)
    E = E.cpu().numpy().astype(np.float64)
    s = np.linalg.svd(E, compute_uv=False)
    conditioning = float(s[1] / s[0]) if s[0] > 1e-12 else 0.0
    cheir = cheir.cpu().numpy()[:N]
    inl = inl.cpu().numpy()[:N]
    return {
        "rotation": R.cpu().numpy().astype(np.float64),
        "translation": t.cpu().numpy().astype(np.float64),
        "inlier_fraction": float(inl.sum() / max(len(inl), 1)),
        "n_inliers": int(inl.sum()),
        "n_total": int(len(inl)),
        "cheirality_inliers": int(cheir.sum()),
        "conditioning": conditioning,
        "norm_a": norm_a,
        "norm_b": norm_b,
        "inlier_index": np.flatnonzero(cheir),
    }


@dataclass
class ScaffoldCloud:
    """A scaffold pair's two-view cloud: keys (M,3) [obj, kp, sync] and
    points (M,3) in camera a's frame, in the pair's correspondence order
    (the JAX package's dict, as arrays)."""

    keys: np.ndarray
    xyz: np.ndarray

    def __len__(self) -> int:
        return len(self.keys)


def triangulate_scaffold(pair_pose: dict, keys: np.ndarray, device=None) -> ScaffoldCloud:
    """Two-view cloud in camera a's frame at unit baseline, on `device`."""
    from caliscope_tpu_torch.ops.triangulate import triangulate_dlt

    idx = pair_pose["inlier_index"]
    if len(idx) == 0:
        return ScaffoldCloud(np.zeros((0, 3), np.int64), np.zeros((0, 3)))
    device = resolve_device(device)
    to = _on(device, resolve_dtype(device))
    na = pair_pose["norm_a"][idx]
    nb = pair_pose["norm_b"][idx]
    P = np.zeros((2, 3, 4))
    P[0, :3, :3] = np.eye(3)
    P[1, :3, :3] = pair_pose["rotation"]
    P[1, :3, 3] = pair_pose["translation"]
    N = len(idx)
    Nb = bucket_size(N)
    xn = pad_rows(np.stack([na, nb], axis=1), Nb)
    vmask = np.zeros((Nb, 2), bool)
    vmask[:N] = True
    Pb = to(P)[None].expand(Nb, 2, 3, 4)
    X = triangulate_dlt(Pb, to(xn), to(vmask, torch.bool))[:N].cpu().numpy().astype(np.float64)
    finite = np.isfinite(X).all(axis=1) & (np.abs(X) < 1e6).all(axis=1)
    return ScaffoldCloud(np.asarray(keys, np.int64)[idx][finite], X[finite])


def resection_camera(cloud: ScaffoldCloud, ip: ImagePoints, cam_id: int, camera: CameraData, seed: int = 0,
                     device=None):
    """Pose one camera against the scaffold cloud by PnP-RANSAC on `device`.

    Returns (R, t, n_points, median normalized reprojection error).
    """
    from caliscope_tpu_torch.ops.epipolar import pnp_ransac
    from caliscope_tpu_torch.ops.lie import so3_exp_host

    if not len(cloud):
        raise ValueError("scaffold cloud is empty")
    rows = np.flatnonzero(ip.cam_id == cam_id)
    cloud_codes, row_codes = _packed(cloud.keys, _keys(ip, rows))
    match = _last_match(cloud_codes, row_codes)
    hit = (match >= 0) & np.isfinite(ip.img_xy[rows]).all(axis=1)
    if hit.sum() < MIN_RESECTION_POINTS:
        raise ValueError(f"only {int(hit.sum())} cloud points to resection against")
    obj = cloud.xyz[match[hit]]
    xn = camera.undistort_points(ip.img_xy[rows[hit]], output="normalized")
    threshold = RANSAC_THRESHOLD_PX / camera.matrix[0, 0]
    device = resolve_device(device)
    to = _on(device, resolve_dtype(device))
    n = len(obj)
    nb = bucket_size(n)
    mask_b = np.zeros(nb, bool)
    mask_b[:n] = True
    rvec, tvec, inl, med = pnp_ransac(
        to(pad_rows(obj, nb)), to(pad_rows(xn, nb)), to(mask_b, torch.bool), threshold,
        n_iters=PNP_RANSAC_ITERS, seed=seed,
    )
    if int(inl.sum()) < 4:
        raise ValueError("PnP-RANSAC failed (too few inliers)")
    R = so3_exp_host(rvec.cpu().numpy().astype(np.float64))
    return R, tvec.cpu().numpy().astype(np.float64), n, float(med)


def _assemble_from_scaffold(scaffold_pair, scaffold_pose, scaffold_keys, cam_ids, ip, camera_array, device=None):
    anchor_cam, other_cam = scaffold_pair
    cloud = triangulate_scaffold(scaffold_pose, scaffold_keys, device=device)
    poses = {
        anchor_cam: (np.eye(3), np.zeros(3)),
        other_cam: (scaffold_pose["rotation"], scaffold_pose["translation"]),
    }
    reproj_errors = []
    n_failures = 0
    for cam_id in cam_ids:
        if cam_id in poses:
            continue
        try:
            R, t, _n, err = resection_camera(cloud, ip, cam_id, camera_array.cameras[cam_id], device=device)
        except ValueError:
            n_failures += 1
            continue
        poses[cam_id] = (R, t)
        reproj_errors.append(err)
    worst = max(reproj_errors) if reproj_errors else 0.0
    return poses, (n_failures, worst, -scaffold_pose["cheirality_inliers"])


def build_epipolar_pose_network(image_points: ImagePoints, camera_array: CameraArray, device=None):
    """Recover the rig from 2D-2D correspondences alone (scale arbitrary),
    on `device` (CUDA unless named)."""
    device = resolve_device(device)
    observed = set(int(c) for c in np.unique(image_points.cam_id))
    cam_ids = sorted(
        cid for cid, cam in camera_array.cameras.items() if not cam.ignore and cid in observed
    )
    if len(cam_ids) < 2:
        raise CalibrationError(
            f"Epipolar bootstrap needs at least 2 cameras with observations, found {len(cam_ids)}."
        )

    pair_poses: dict[tuple[int, int], dict] = {}
    pair_keys: dict[tuple[int, int], np.ndarray] = {}
    for cam_a, cam_b in combinations(cam_ids, 2):
        keys, pa, pb = pooled_correspondences(image_points, cam_a, cam_b)
        if len(keys) < MIN_CORRESPONDENCES:
            continue
        try:
            pose = recover_pair_pose(
                pa, pb, camera_a=camera_array.cameras[cam_a], camera_b=camera_array.cameras[cam_b],
                seed=cam_a * 1000 + cam_b, device=device,
            )
        except ValueError as exc:
            logger.warning(f"Pair {cam_a}-{cam_b}: essential-matrix recovery failed ({exc})")
            continue
        pair_poses[(cam_a, cam_b)] = pose
        pair_keys[(cam_a, cam_b)] = keys
        logger.info(
            f"Pair {cam_a}-{cam_b}: {pose['n_inliers']}/{pose['n_total']} inliers, "
            f"{pose['cheirality_inliers']} cheirality, E conditioning {pose['conditioning']:.3f}"
        )
        if pose["conditioning"] < CONDITIONING_FLOOR:
            logger.warning(
                f"Pair {cam_a}-{cam_b}: essential matrix poorly conditioned "
                f"({pose['conditioning']:.3f} < {CONDITIONING_FLOOR})."
            )

    if not pair_poses:
        raise CalibrationError(
            f"Insufficient camera overlap for epipolar bootstrap: no camera pair reached the "
            f"{MIN_CORRESPONDENCES} shared correspondences an essential matrix needs. Cameras must "
            f"share observations of the moving subject across frames."
        )

    candidates = sorted(pair_poses, key=lambda p: pair_poses[p]["cheirality_inliers"], reverse=True)
    candidates = candidates[:MAX_SCAFFOLD_CANDIDATES]

    best_poses, best_score, best_pair = None, None, None
    for pair in candidates:
        poses, score = _assemble_from_scaffold(
            pair, pair_poses[pair], pair_keys[pair], cam_ids, image_points, camera_array, device=device
        )
        if best_score is None or score < best_score:
            best_poses, best_score, best_pair = poses, score, pair

    anchor_cam = best_pair[0]
    logger.info(
        f"Selected scaffold {best_pair[0]}-{best_pair[1]} (failures={best_score[0]}, "
        f"worst third-view reprojection={best_score[1]:.5f}); posed "
        f"{len(best_poses)}/{len(cam_ids)} cameras, anchor = cam {anchor_cam}"
    )

    # anchor-relative StereoPairs (primary < secondary), each scored by its
    # stereo RMSE as the PnP path scores them
    aggregated: dict[tuple[int, int], StereoPair] = {}
    for cam_id, (R, t) in best_poses.items():
        if cam_id == anchor_cam:
            continue
        sp = StereoPair(anchor_cam, cam_id, float("nan"), R, t)
        if sp.primary_cam_id > sp.secondary_cam_id:
            sp = sp.inverted()
        aggregated[sp.pair] = sp

    rmse = stereo_rmse_batch(list(aggregated.values()), image_points, camera_array, device=device)
    scored: dict[tuple[int, int], StereoPair] = {}
    for pair, sp in aggregated.items():
        score = rmse[pair] if np.isfinite(rmse[pair]) else 1e6
        scored[pair] = StereoPair(sp.primary_cam_id, sp.secondary_cam_id, score, sp.rotation, sp.translation)

    return PairedPoseNetwork.from_raw_estimates(scored)
