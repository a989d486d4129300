"""Pose-network bootstrap: PnP resection -> relative poses -> stereo graph.

Port of caliscope_tpu/solvers/pose_network.py. The transitive chaining
lets camera pairs that never co-observe the target still be calibrated by
bridging through intermediates.

Device and host, as in the JAX package: the undistortion and the batched
resection of every (sync, camera, object) group (`solve_pnp_batch`), the
stereo-pair triangulations and the RANSAC resections of the scaffold
assembly run on `device` (CUDA unless the caller names another); the graph
algebra (IQR rejection, quaternion averaging, bridging, anchor selection)
runs on the host in numpy float64 on tiny per-pair arrays, with the numpy
twins of ops/lie.py.

The PnP batch and the RANSAC resections run in the device's default dtype
(float32 on CUDA, as the JAX package runs them on the TPU; float64 on the
CPU) unless the caller gives one. A flat board's smallest scatter
eigenvalue in float32 is roundoff, about 1e-7 of the largest, inside the
1e-6 planarity limit by less than a decade: chip_smoke.py runs the batch in
float64 beside it on every run and fails if the two keep different groups
or part by more than 0.01 degree (at 8 cameras x 600 frames: the same 4,800
groups, 3.6e-4 degree apart at most; PERF.md, PR 5).

Conventions: T_cam_obj maps object frame -> camera frame. A StereoPair
(primary=A, secondary=B) stores T_B_A (point in A's frame -> B's frame).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from itertools import permutations
from pathlib import Path

import numpy as np
import torch

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.ops import lie
from caliscope_tpu_torch.ops.bucket import bucket_size, pad_rows
from caliscope_tpu_torch.tracing import span

logger = logging.getLogger(__name__)

DEFAULT_MIN_PNP_POINTS = 4
MIN_NONPLANAR_PNP_POINTS = 6
DEFAULT_OUTLIER_THRESHOLD = 1.5  # IQR multiplier


def _on(device, dtype):
    def to(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dt)

    return to


# ---------------------------------------------------------------------------
# Stage 1: batched camera-to-object PnP
# ---------------------------------------------------------------------------


@dataclass
class CameraObjectPoses:
    """Flat arrays of per-(sync, cam, object) resection results."""

    sync_index: np.ndarray  # (G,)
    cam_id: np.ndarray  # (G,)
    object_id: np.ndarray  # (G,)
    rvec: np.ndarray  # (G,3) object->camera
    tvec: np.ndarray  # (G,3)
    rms: np.ndarray  # (G,) normalized-coords reprojection rms
    n_points: np.ndarray  # (G,)


def estimate_camera_object_poses(
    image_points: ImagePoints,
    camera_array: CameraArray,
    min_points: int = DEFAULT_MIN_PNP_POINTS,
    device=None,
    dtype=None,
) -> CameraObjectPoses:
    """Resect every (sync, camera, object) group with known obj_loc, in one
    batch on `device` (in its default dtype unless `dtype` is given).

    Groups with planar geometry need >= min_points, non-planar >= 6."""
    from caliscope_tpu_torch.ops.pnp import solve_pnp_batch
    from caliscope_tpu_torch.ops.projection import undistort_points

    device = resolve_device(device)
    to = _on(device, resolve_dtype(device, dtype))
    views = camera_array.device_views(device="cpu", dtype=torch.float64)
    id_to_idx = {int(c): i for i, c in enumerate(views.cam_ids)}

    has_obj = np.isfinite(image_points.obj_loc).all(axis=1)
    known_cam = np.isin(image_points.cam_id, views.cam_ids)
    ip = image_points.select(has_obj & known_cam)
    if len(ip) == 0:
        raise CalibrationError(
            "No observations with known object coordinates (obj_loc); "
            "PnP bootstrap requires a calibration target with known geometry. "
            "For markerless data use the epipolar bootstrap."
        )

    cam_idx = np.array([id_to_idx[int(c)] for c in ip.cam_id])
    # undistort every observation in one batch, rows bucketed as the JAX
    # package buckets them (identity-K filler)
    K_obs = views.K.numpy()[cam_idx]
    d_obs = views.dist.numpy()[cam_idx]
    fe_obs = views.fisheye.numpy()[cam_idx]
    N = len(ip)
    Nb = bucket_size(N)
    uv_b = to(pad_rows(ip.img_xy, Nb))
    K_b = pad_rows(K_obs, Nb)
    K_b[N:] = np.eye(3)
    d_b = pad_rows(d_obs, Nb)
    xn = undistort_points(uv_b, to(K_b), to(d_b), False)
    if fe_obs.any():
        xn_f = undistort_points(uv_b, to(K_b), to(d_b[:, :4]), True)
        xn = torch.where(to(pad_rows(fe_obs, Nb), torch.bool)[:, None], xn_f, xn)
    xn = xn[:N].cpu().numpy()

    # group by (sync, cam, obj)
    gkeys = np.stack([ip.sync_index, ip.cam_id, ip.object_id], axis=1)
    uniq, inverse, counts = np.unique(gkeys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    keep_groups = np.where(counts >= min_points)[0]
    if len(keep_groups) == 0:
        raise CalibrationError(
            f"No (sync, camera, object) group has >= {min_points} observations; "
            f"cannot run PnP. Check detection quality or lower min_points."
        )
    remap = -np.ones(len(uniq), dtype=np.int64)
    remap[keep_groups] = np.arange(len(keep_groups))
    g_of_obs = remap[inverse]
    obs_keep = g_of_obs >= 0

    G = len(keep_groups)
    Kmax = int(counts[keep_groups].max())
    # padded batch shape bucketed to powers of two, as the JAX package does
    Gb = bucket_size(G)
    Kb = bucket_size(Kmax, floor=8)
    obj_pad = np.zeros((Gb, Kb, 3))
    img_pad = np.zeros((Gb, Kb, 2))
    mask_pad = np.zeros((Gb, Kb), bool)
    order = np.argsort(g_of_obs[obs_keep], kind="stable")
    rows = np.where(obs_keep)[0][order]
    g_sorted = g_of_obs[rows]
    slot = np.arange(len(rows)) - np.searchsorted(g_sorted, g_sorted)
    obj_pad[g_sorted, slot] = ip.obj_loc[rows]
    img_pad[g_sorted, slot] = xn[rows]
    mask_pad[g_sorted, slot] = True

    out = solve_pnp_batch(to(obj_pad), to(img_pad), to(mask_pad, torch.bool))
    rvec, tvec, rms, n_pts = (a[:G].cpu().numpy() for a in out)
    rvec, tvec, rms = (a.astype(np.float64) for a in (rvec, tvec, rms))
    obj_pad, mask_pad = obj_pad[:G], mask_pad[:G]
    keys = uniq[keep_groups]

    # the non-planar minimum, enforced after the fact (planarity per group)
    centered = obj_pad - obj_pad.mean(axis=1, keepdims=True)
    centered[~mask_pad] = 0.0
    svals = np.linalg.svd(centered, compute_uv=False)
    planar = svals[:, 2] < 1e-6 * np.maximum(svals[:, 0], 1e-12)
    ok = n_pts >= np.where(planar, min_points, MIN_NONPLANAR_PNP_POINTS)
    # drop degenerate solves (e.g. 4 collinear corners): one NaN view would
    # poison every relative-pose average its camera takes part in
    ok &= np.isfinite(rvec).all(axis=1) & np.isfinite(tvec).all(axis=1) & np.isfinite(rms)

    return CameraObjectPoses(
        sync_index=keys[ok, 0],
        cam_id=keys[ok, 1],
        object_id=keys[ok, 2],
        rvec=rvec[ok],
        tvec=tvec[ok],
        rms=rms[ok],
        n_points=n_pts[ok],
    )


# ---------------------------------------------------------------------------
# Stage 2: relative pose samples + robust aggregation
# ---------------------------------------------------------------------------


def relative_pose_samples(poses: CameraObjectPoses) -> dict[tuple[int, int], dict]:
    """For every (sync, object) seen by two cameras A < B, sample
    T_B_A = T_B_obj @ inv(T_A_obj). Returns per-pair stacked samples."""
    R_all = lie.so3_exp_host(poses.rvec)
    by_sync_obj: dict[tuple[int, int], list[int]] = {}
    for i, (s, o) in enumerate(zip(poses.sync_index, poses.object_id)):
        by_sync_obj.setdefault((int(s), int(o)), []).append(i)

    samples: dict[tuple[int, int], dict] = {}
    for idxs in by_sync_obj.values():
        idxs = sorted(idxs, key=lambda i: poses.cam_id[i])
        for ai in range(len(idxs)):
            for bi in range(len(idxs)):
                if ai == bi:
                    continue
                i, j = idxs[ai], idxs[bi]
                a, b = int(poses.cam_id[i]), int(poses.cam_id[j])
                if a >= b:
                    continue
                R_a, t_a = R_all[i], poses.tvec[i]
                R_b, t_b = R_all[j], poses.tvec[j]
                R_ab = R_b @ R_a.T
                t_ab = t_b - R_ab @ t_a
                d = samples.setdefault((a, b), {"R": [], "t": [], "rms": []})
                d["R"].append(R_ab)
                d["t"].append(t_ab)
                d["rms"].append(0.5 * (poses.rms[i] + poses.rms[j]))
    for d in samples.values():
        d["R"] = np.stack(d["R"])
        d["t"] = np.stack(d["t"])
        d["rms"] = np.asarray(d["rms"])
    return samples


def reject_outliers(
    samples: dict[tuple[int, int], dict],
    threshold: float = DEFAULT_OUTLIER_THRESHOLD,
    rotation_threshold_multiplier: float | None = None,
    translation_threshold_multiplier: float | None = None,
) -> dict[tuple[int, int], dict]:
    """IQR rejection per pair: translation magnitude (two-sided) + geodesic
    rotation angle to the samples' medoid (upper-bounded)."""
    rot_mult = rotation_threshold_multiplier if rotation_threshold_multiplier is not None else threshold
    t_mult = translation_threshold_multiplier if translation_threshold_multiplier is not None else threshold
    out: dict[tuple[int, int], dict] = {}
    for pair, d in samples.items():
        R, t, rms = d["R"], d["t"], d["rms"]
        keep = np.ones(len(t), bool)
        if len(t) >= 4:
            t_mag = np.linalg.norm(t, axis=1)
            q1, q3 = np.percentile(t_mag, [25, 75])
            iqr = q3 - q1
            keep &= (t_mag >= q1 - t_mult * iqr) & (t_mag <= q3 + t_mult * iqr)

            # Rotation mode-seeking: planar-PnP flip contamination makes the
            # sample set bimodal, where an eigen-average lands between the
            # modes. The medoid (minimum summed geodesic distance) sits in
            # the dominant mode; IQR-gate the angles to it.
            quats = lie.quat_from_matrix_host(R)
            dots = np.abs(quats @ quats.T).clip(0, 1)
            geo = 2.0 * np.arccos(dots)
            medoid = int(np.argmin(geo.sum(axis=1)))
            angles = geo[medoid]
            rq1, rq3 = np.percentile(angles, [25, 75])
            keep &= angles <= max(rq3 + rot_mult * (rq3 - rq1), np.deg2rad(2.0))
        if keep.sum() == 0:
            keep[:] = True  # never drop a pair entirely at this stage
        out[pair] = {"R": R[keep], "t": t[keep], "rms": rms[keep]}
    return out


@dataclass(frozen=True)
class StereoPair:
    """T_secondary_primary with a conservative error score (pixels)."""

    primary_cam_id: int
    secondary_cam_id: int
    error_score: float
    rotation: np.ndarray  # (3,3)
    translation: np.ndarray  # (3,)

    @property
    def pair(self) -> tuple[int, int]:
        return (self.primary_cam_id, self.secondary_cam_id)

    @property
    def transformation(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m

    def inverted(self) -> "StereoPair":
        R, t = lie.se3_inverse_host(self.rotation, self.translation)
        return StereoPair(self.secondary_cam_id, self.primary_cam_id, self.error_score, R, t)

    def link(self, other: "StereoPair") -> "StereoPair":
        """Compose A->B with B->C into A->C; errors sum (a conservative bound)."""
        if self.secondary_cam_id != other.primary_cam_id:
            raise ValueError(f"Cannot link {self.pair} with {other.pair}")
        R = other.rotation @ self.rotation
        t = other.rotation @ self.translation + other.translation
        return StereoPair(self.primary_cam_id, other.secondary_cam_id, self.error_score + other.error_score, R, t)


def aggregate_pairs(
    samples: dict[tuple[int, int], dict],
    image_points: ImagePoints | None = None,
    camera_array: CameraArray | None = None,
    device=None,
) -> dict[tuple[int, int], StereoPair]:
    """Average inlier samples per pair (eigen quaternion mean + mean t), then
    score each pair by stereo reprojection RMSE over co-observations."""
    pairs: dict[tuple[int, int], StereoPair] = {}
    for (a, b), d in samples.items():
        quats = lie.quat_from_matrix_host(d["R"])
        R_mean = lie.matrix_from_quat_host(lie.quaternion_average_host(quats))
        t_mean = d["t"].mean(axis=0)
        err = float(np.mean(d["rms"]))
        pairs[(a, b)] = StereoPair(a, b, err, R_mean, t_mean)

    if image_points is not None and camera_array is not None:
        scores = stereo_rmse_batch(list(pairs.values()), image_points, camera_array, device=device)
        for key, sp in list(pairs.items()):
            if np.isfinite(scores[key]):
                pairs[key] = StereoPair(sp.primary_cam_id, sp.secondary_cam_id, scores[key], sp.rotation, sp.translation)
    return pairs


def stereo_rmse(pair: StereoPair, image_points: ImagePoints, camera_array: CameraArray, device=None) -> float:
    """Pair quality: `stereo_rmse_batch` of the one pair."""
    return stereo_rmse_batch([pair], image_points, camera_array, device=device)[pair.pair]


# Blocks (a pair and one point both its cameras see) a device pass takes at
# most, in whole pairs: a block's two-view DLT and its rows' float64
# residuals hold ~0.45 KB at the pass's peak (0.25 GB for the 588,000 blocks
# of 8 cameras x 21,000 points on an H100, over the ~4.5 GB workspace that
# torch.linalg.eigh takes for each of triangulate_dlt's batches of 16,384).
SCORE_CHUNK = 1 << 20


def stereo_rmse_batch(
    pairs: list[StereoPair], image_points: ImagePoints, camera_array: CameraArray, device=None
) -> dict[tuple[int, int], float]:
    """Each pair's quality, cv2.stereoCalibrate's score: triangulate the
    pair's co-observations with (I | T_b_a) on `device` (in its default
    dtype), reproject in float64, pixel RMSE. nan where fewer than 10 rows
    (observations of points both cameras see) remain or none is scored.

    One pass for all pairs. The host numbers the points, (sync_index,
    object_id, keypoint_id), once over the pairs' cameras and lists each
    pair's co-observed points; the device undistorts every row once,
    triangulates every (pair, point) block, reprojects and sums squares per
    pair, and the sums come back in one read. Each score is the one pair's
    rule: a point is triangulated from its first two rows in the pair in
    the rows' order and every row of it is scored; both cameras' rows are
    undistorted with camera A's model flag, as the JAX package does."""
    from caliscope_tpu_torch.ops.projection import undistort_points
    from caliscope_tpu_torch.ops.triangulate import triangulate_dlt

    device = resolve_device(device)
    to = _on(device, resolve_dtype(device))
    scores = {sp.pair: np.nan for sp in pairs}
    with span("bootstrap.score") as record:
        cam_ids = np.array(sorted({c for sp in pairs for c in sp.pair}))
        keep = np.isin(image_points.cam_id, cam_ids)
        N, C = int(keep.sum()), len(cam_ids)
        if N == 0:
            return scores
        cam = np.searchsorted(cam_ids, image_points.cam_id[keep])
        sync, obj, kp = image_points.sync_index[keep], image_points.object_id[keep], image_points.keypoint_id[keep]

        # a dense point number; per (point, camera) its rows' count and its
        # first two rows in the rows' order (N: none)
        order = np.lexsort((kp, obj, sync))
        new = np.ones(N, bool)
        new[1:] = (np.diff(sync[order]) != 0) | (np.diff(obj[order]) != 0) | (np.diff(kp[order]) != 0)
        point = np.empty(N, np.int64)
        point[order] = np.cumsum(new) - 1
        n_points = int(point[order[-1]]) + 1
        pc = point * C + cam
        by_pc = np.argsort(pc, kind="stable")
        starts = np.flatnonzero(np.r_[True, np.diff(pc[by_pc]) != 0])
        count = np.bincount(pc, minlength=n_points * C)
        first, second = np.full(n_points * C, N), np.full(n_points * C, N)
        first[pc[by_pc[starts]]] = by_pc[starts]
        twice = starts[count[pc[by_pc[starts]]] > 1]
        second[pc[by_pc[twice]]] = by_pc[twice + 1]
        count, first, second = (x.reshape(n_points, C) for x in (count, first, second))
        rows_of = [np.flatnonzero(cam == c) for c in range(C)]

        # per pair: a block a point both cameras see, triangulated from its
        # first two rows in the pair; every row of it scored
        ca = np.searchsorted(cam_ids, [sp.primary_cam_id for sp in pairs])
        cb = np.searchsorted(cam_ids, [sp.secondary_cam_id for sp in pairs])
        scored, views, res_block, res_row, n_blocks, n_rows = [], [], [], [], [], []
        for q, (a, b) in enumerate(zip(ca, cb)):
            both = (count[:, a] > 0) & (count[:, b] > 0)
            rows = np.concatenate([rows_of[a], rows_of[b]])
            rows = rows[both[point[rows]]]
            if len(rows) < 10:
                continue
            pts = np.flatnonzero(both)
            fa, sa, fb, sb = first[pts, a], second[pts, a], first[pts, b], second[pts, b]
            views.append(np.stack([np.minimum(fa, fb), np.where(fa < fb, np.minimum(sa, fb), np.minimum(fa, sb))], 1))
            res_block.append(sum(n_blocks) + (np.cumsum(both) - 1)[point[rows]])
            res_row.append(rows)
            scored.append(q)
            n_blocks.append(len(pts))
            n_rows.append(len(rows))
        if not scored:
            return scores
        q_of = np.repeat(scored, n_blocks)
        # chunks of whole pairs, at most SCORE_CHUNK blocks each unless one
        # pair alone has more
        cuts, filled = [0], 0
        for i, n in enumerate(n_blocks):
            if filled and filled + n > SCORE_CHUNK:
                cuts.append(i)
                filled = 0
            filled += n
        cuts.append(len(scored))
        block_at, row_at = np.r_[0, np.cumsum(n_blocks)], np.r_[0, np.cumsum(n_rows)]

        # per camera: K, distortions (zero-padded), fx, model flag; per pair:
        # its two projections and the model both its cameras' rows are
        # undistorted with, camera A's
        cams = [camera_array.cameras[int(c)] for c in cam_ids]
        dist = np.zeros((C, max(len(np.ravel(c.distortions)) for c in cams)))
        for i, c in enumerate(cams):
            dist[i, : len(np.ravel(c.distortions))] = np.ravel(c.distortions)
        K = np.stack([c.matrix for c in cams])
        fisheye = np.array([bool(c.fisheye) for c in cams])
        proj = np.zeros((len(pairs), 2, 3, 4))
        proj[:, :, :3, :3] = np.eye(3)
        proj[:, 1, :3, :3] = [sp.rotation for sp in pairs]
        proj[:, 1, :3, 3] = [np.ravel(sp.translation) for sp in pairs]
        models = sorted(set(fisheye[ca[scored]].tolist()))
        model_of = np.searchsorted(models, fisheye[ca])

        # uploads, all before the device work
        cam_t = to(cam, torch.int64)
        uv, K_rows, d_rows = to(image_points.img_xy[keep]), to(K)[cam_t], to(dist)[cam_t]
        f_rows = to(K[:, 0, 0], torch.float64)[cam_t]
        cb_t, model_t = to(cb, torch.int64), to(model_of, torch.int64)
        proj_t, proj64 = to(proj), to(proj, torch.float64)
        q_t, views_t = to(q_of, torch.int64), to(np.concatenate(views), torch.int64)
        res_block_t, res_row_t = to(np.concatenate(res_block), torch.int64), to(np.concatenate(res_row), torch.int64)

        xn = torch.stack([undistort_points(uv, K_rows, d_rows, m) for m in models])  # (models, N, 2)
        sums = torch.zeros(2, len(pairs), dtype=torch.float64, device=device)
        for i0, i1 in zip(cuts[:-1], cuts[1:]):
            e0, e1, r0, r1 = block_at[i0], block_at[i1], row_at[i0], row_at[i1]
            q, v = q_t[e0:e1], views_t[e0:e1]
            side = (cam_t[v] == cb_t[q][:, None]).long()  # 0: [I|0], 1: [R|t]
            xyz = triangulate_dlt(proj_t[q[:, None], side], xn[model_t[q][:, None], v], torch.ones_like(side, dtype=torch.bool))

            block, row = res_block_t[r0:r1], res_row_t[r0:r1]
            q = q_t[block]
            P = proj64[q, (cam_t[row] == cb_t[q]).long()]
            Xh = torch.cat([xyz[block - e0].to(torch.float64), torch.ones_like(f_rows[row])[:, None]], dim=1)
            xc = torch.einsum("nij,nj->ni", P, Xh)
            ok = xc[:, 2] > 1e-6
            uvn = xc[:, :2] / torch.where(ok, xc[:, 2], torch.ones_like(xc[:, 2]))[:, None]
            err = torch.linalg.norm(uvn - xn[model_t[q], row].to(torch.float64), dim=1) * f_rows[row]
            sums[0].index_add_(0, q, torch.where(ok, err**2, torch.zeros_like(err)))
            sums[1].index_add_(0, q, ok.to(torch.float64))
        total, count = sums.cpu().numpy()
        if record is not None:
            record.attrs.update(pairs=len(pairs), points=len(q_of), reads=1)
    for q, sp in enumerate(pairs):
        if count[q] > 0:
            scores[sp.pair] = float(np.sqrt(total[q] / count[q]))
    return scores


# ---------------------------------------------------------------------------
# Stage 3: the stereo-pair graph
# ---------------------------------------------------------------------------


class PairedPoseNetwork:
    """Graph of StereoPairs with gap bridging and anchor selection."""

    def __init__(self, pairs: dict[tuple[int, int], StereoPair]):
        self._pairs = dict(pairs)

    @property
    def pairs(self) -> dict[tuple[int, int], StereoPair]:
        return dict(self._pairs)

    @classmethod
    def from_raw_estimates(cls, raw_pairs: dict[tuple[int, int], StereoPair]) -> "PairedPoseNetwork":
        """Add inverses, then iteratively bridge missing (A,C) through the
        best intermediate X by summed error until no progress."""
        all_pairs = dict(raw_pairs)
        for p in list(all_pairs.values()):
            inv = p.inverted()
            all_pairs.setdefault(inv.pair, inv)

        cam_ids = sorted({c for pair in all_pairs for c in pair})
        last_missing = -1
        while True:
            missing = [p for p in permutations(cam_ids, 2) if p not in all_pairs]
            if not missing or len(missing) == last_missing:
                break
            last_missing = len(missing)
            for a, c in missing:
                best = None
                for x in cam_ids:
                    if (a, x) in all_pairs and (x, c) in all_pairs:
                        cand = all_pairs[(a, x)].link(all_pairs[(x, c)])
                        if best is None or cand.error_score < best.error_score:
                            best = cand
                if best is not None:
                    all_pairs[best.pair] = best
                    inv = best.inverted()
                    all_pairs[inv.pair] = inv
        return cls(all_pairs)

    def get_pair(self, a: int, b: int) -> StereoPair | None:
        return self._pairs.get((a, b))

    def connected_components(self, cam_ids: list[int]) -> list[set[int]]:
        adj: dict[int, set[int]] = {c: set() for c in cam_ids}
        for a, b in self._pairs:
            if a in adj and b in adj:
                adj[a].add(b)
                adj[b].add(a)
        seen: set[int] = set()
        comps = []
        for c in cam_ids:
            if c in seen:
                continue
            stack, comp = [c], set()
            while stack:
                v = stack.pop()
                if v in comp:
                    continue
                comp.add(v)
                stack.extend(adj[v] - comp)
            seen |= comp
            comps.append(comp)
        return comps

    def largest_connected_component(self, cam_ids: list[int]) -> set[int]:
        comps = self.connected_components(cam_ids)
        return max(comps, key=len) if comps else set()

    def _anchored_config(self, anchor: int, cam_ids: list[int]):
        """Anchor camera at identity; camera X <- T_X_anchor. Returns
        (total error, {cam_id: (R, t)})."""
        total = 0.0
        config: dict[int, tuple[np.ndarray, np.ndarray]] = {anchor: (np.eye(3), np.zeros(3))}
        for cid in cam_ids:
            if cid == anchor:
                continue
            sp = self._pairs.get((anchor, cid))
            if sp is None:
                continue
            config[cid] = (sp.rotation, sp.translation)
            total += sp.error_score
        return total, config

    def apply_to(self, camera_array: CameraArray, anchor_cam: int | None = None) -> int:
        """Pose the largest connected component, choosing the anchor with the
        lowest total error unless given. Mutates camera_array; returns the
        anchor cam_id."""
        cam_ids = sorted(camera_array.cameras.keys())
        main_group = sorted(self.largest_connected_component(cam_ids))
        if not main_group:
            raise CalibrationError(
                "Pose network has no connected cameras; check that cameras co-observe the calibration target."
            )
        if anchor_cam is None:
            best_err, best_anchor, best_cfg = np.inf, None, None
            for cand in main_group:
                err, cfg = self._anchored_config(cand, main_group)
                if len(cfg) == len(main_group) and err < best_err:
                    best_err, best_anchor, best_cfg = err, cand, cfg
            if best_anchor is None:
                raise CalibrationError("No anchor camera can reach every camera in the main group.")
            anchor_cam, config = best_anchor, best_cfg
        else:
            _, config = self._anchored_config(anchor_cam, main_group)

        for cid, (R, t) in config.items():
            camera_array.cameras[cid].rotation = R.copy()
            camera_array.cameras[cid].translation = t.copy()
        unposed = [c for c in cam_ids if c not in config]
        if unposed:
            logger.warning(f"Cameras not in the main group remain unposed: {unposed}")
        return anchor_cam

    # ---- persistence -------------------------------------------------------
    def to_toml(self, path: Path | str) -> None:
        """Write the stereo_pairs.toml schema: keys ``stereo_{a}_{b}`` for
        forward pairs only, fields RMSE / rotation (Rodrigues) / translation."""
        from caliscope_tpu_torch import persistence

        data = {}
        for (a, b), sp in sorted(self._pairs.items()):
            if a >= b:
                continue
            data[f"stereo_{a}_{b}"] = {
                "RMSE": float(sp.error_score),
                "rotation": lie.so3_log_host(sp.rotation).tolist(),
                "translation": sp.translation.reshape(-1).tolist(),
            }
        persistence.safe_write_toml(data, path)

    @classmethod
    def from_toml(cls, path: Path | str) -> "PairedPoseNetwork":
        """Read stereo_pairs.toml: cam ids from the ``stereo_{a}_{b}`` key,
        translation as (3,) or a (3,1) column, the full graph reconstructed
        by bridging."""
        from caliscope_tpu_torch import persistence

        data = persistence.load_toml(path)
        pairs = {}
        for key, v in data.items():
            name_parts = str(key).split("_")
            if len(name_parts) != 3:
                logger.warning(f"Skipping invalid stereo pair key: {key}")
                continue
            a, b = int(name_parts[1]), int(name_parts[2])
            R = lie.so3_exp_host(np.asarray(v["rotation"], dtype=np.float64))
            t = np.asarray(v["translation"], dtype=np.float64).reshape(-1)
            pairs[(a, b)] = StereoPair(a, b, float(v.get("RMSE", 0.0)), R, t)
        return cls.from_raw_estimates(pairs)


# ---------------------------------------------------------------------------
# Scaffold assembly
# ---------------------------------------------------------------------------


def resect_against_cloud(image_points, camera, cloud, static_object_ids, device, seed):
    """PnP-RANSAC of one camera against a triangulated cloud, on `device` in
    its default dtype: (R, t, median error) or None when fewer than 6 of its
    observations join the cloud or fewer than 6 inliers remain. Shared by
    the scaffold assembly and the bootstrap's outlier-camera repair."""
    from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX
    from caliscope_tpu_torch.ops.epipolar import pnp_ransac

    key_to_row = {tuple(k): i for i, k in enumerate(cloud.keys())}
    sel = np.where(image_points.cam_id == camera.cam_id)[0]
    sync = image_points.sync_index[sel].copy()
    if static_object_ids:
        sync[np.isin(image_points.object_id[sel], list(static_object_ids))] = STATIC_SYNC_INDEX
    rows = np.array(
        [
            key_to_row.get((int(s), int(o), int(k)), -1)
            for s, o, k in zip(sync, image_points.object_id[sel], image_points.keypoint_id[sel])
        ]
    )
    ok = rows >= 0
    if ok.sum() < 6:
        return None
    obj = cloud.xyz[rows[ok]]
    xn = camera.undistort_points(image_points.img_xy[sel][ok], output="normalized")
    thr = 3.0 / camera.matrix[0, 0]
    # bucketed rows, as the JAX package does
    nb = bucket_size(len(obj))
    mask_b = np.zeros(nb, bool)
    mask_b[: len(obj)] = True
    device = resolve_device(device)
    to = _on(device, resolve_dtype(device))
    rvec, tvec, inl, med = pnp_ransac(to(pad_rows(obj, nb)), to(pad_rows(xn, nb)), to(mask_b, torch.bool), thr, seed=seed)
    if int(inl.sum()) < 6:
        return None
    return lie.so3_exp_host(rvec.cpu().numpy()), tvec.cpu().numpy(), float(med)


def scaffold_assembly(
    image_points: ImagePoints,
    camera_array: CameraArray,
    pose_network: "PairedPoseNetwork",
    max_candidates: int = 6,
    static_object_ids: frozenset[int] = frozenset(),
    device=None,
    dtype=None,
) -> CameraArray | None:
    """Rebuild the rig from one trusted stereo pair + cloud resection.

    When co-visibility is sparse, transitively-chained pairwise estimates can
    go wrong while every individual PnP looks fine (planar flip ambiguity,
    too few samples for rejection). This assembly takes the best-scoring
    pairs as scaffold candidates: pose the pair from its StereoPair
    transform, triangulate their co-observations, resect every other camera
    against that cloud (PnP-RANSAC), and keep the candidate whose cloud the
    other cameras explain best.

    Returns a newly-posed copy of camera_array, or None if no candidate works.
    """
    cam_ids = sorted({int(c) for c in np.unique(image_points.cam_id)} & set(camera_array.cameras.keys()))
    if len(cam_ids) < 2:
        return None
    direct = [
        sp
        for (a, b), sp in pose_network.pairs.items()
        if a < b and a in cam_ids and b in cam_ids and np.isfinite(sp.error_score)
    ]
    direct.sort(key=lambda sp: sp.error_score)
    candidates = direct[:max_candidates]
    if not candidates:
        return None

    def assemble(sp: StereoPair):
        cams = camera_array.copy()
        for c in cams.cameras.values():
            c.rotation = None
            c.translation = None
        a, b = sp.primary_cam_id, sp.secondary_cam_id
        cams.cameras[a].rotation = np.eye(3)
        cams.cameras[a].translation = np.zeros(3)
        cams.cameras[b].rotation = sp.rotation.copy()
        cams.cameras[b].translation = sp.translation.copy()
        posed = {a, b}
        errors = []
        # incremental expansion: each newly-posed camera grows the cloud,
        # which can make previously-unresectable cameras solvable
        while True:
            cloud_obs = image_points.select(np.isin(image_points.cam_id, sorted(posed)))
            cloud = cloud_obs.triangulate(cams, static_object_ids=static_object_ids, device=device, dtype=dtype)
            if len(cloud) < 8:
                return None, (len(cam_ids), np.inf)
            added = False
            for cid in cam_ids:
                if cid in posed:
                    continue
                result = resect_against_cloud(image_points, cams.cameras[cid], cloud, static_object_ids, device, cid)
                if result is None:
                    continue
                R, t, med = result
                cams.cameras[cid].rotation = R
                cams.cameras[cid].translation = t
                posed.add(cid)
                errors.append(med)
                added = True
            if not added:
                break
        n_fail = len(cam_ids) - len(posed)
        return cams, (n_fail, max(errors) if errors else 0.0)

    best_cams, best_score = None, None
    for sp in candidates:
        cams, score = assemble(sp)
        if cams is None:
            continue
        if best_score is None or score < best_score:
            best_cams, best_score = cams, score
    if best_cams is None:
        return None
    logger.info(f"Scaffold assembly selected pair with score {best_score}")
    return best_cams


# ---------------------------------------------------------------------------
# Top-level builder
# ---------------------------------------------------------------------------


def build_pose_network(
    image_points: ImagePoints,
    camera_array: CameraArray,
    device=None,
    **kwargs,
) -> "PairedPoseNetwork":
    """Bootstrap dispatch: obj_loc present on any observation -> PnP path;
    all-NaN -> the markerless (essential-matrix) path of solvers/epipolar.py."""
    if image_points.any_obj_loc:
        return build_pnp_pose_network(image_points, camera_array, device=device, **kwargs)
    from caliscope_tpu_torch.solvers.epipolar import build_epipolar_pose_network

    return build_epipolar_pose_network(image_points, camera_array, device=device)


def build_pnp_pose_network(
    image_points: ImagePoints,
    camera_array: CameraArray,
    min_points: int = DEFAULT_MIN_PNP_POINTS,
    outlier_threshold: float = DEFAULT_OUTLIER_THRESHOLD,
    device=None,
) -> PairedPoseNetwork:
    """PnP path of the bootstrap dispatch: resect -> relative poses -> IQR
    filter -> aggregate -> bridge, on `device`."""
    with span("bootstrap.pnp"):
        poses = estimate_camera_object_poses(image_points, camera_array, min_points, device=device)
    with span("bootstrap.pairs"):
        samples = relative_pose_samples(poses)
        if not samples:
            raise CalibrationError(
                "No camera pair co-observes the calibration target in any frame; cannot estimate relative poses."
            )
        inliers = reject_outliers(samples, outlier_threshold)
        raw_pairs = aggregate_pairs(inliers, image_points, camera_array, device=device)
        return PairedPoseNetwork.from_raw_estimates(raw_pairs)
