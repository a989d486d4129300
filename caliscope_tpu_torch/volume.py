"""CaptureVolume: the frozen calibration aggregate and its operations.

Port of caliscope_tpu/volume.py. Every transform returns a new frozen
instance. `bootstrap()` poses the cameras from the pose network
(solvers/pose_network.py), triangulates, re-assembles a badly chained rig
from its best stereo pair and re-resects outlier cameras. `optimize()`
buckets the observation and point counts and picks the dense point-minor
layout exactly as the JAX package does, then runs the port's LM solve
(solvers/bundle.py) on the volume's device; reports and filters reuse the
same reprojection code. Anchoring by a similarity transform
(`align_to_object`, `scaled`, `oriented`, `grounded`, `rotate`,
`translate`, `centered`) and the volumetric-scale QA run on the host.

A volume may carry a `ConstraintSet` (constraints.py): its static objects
join their observations onto one world point per keypoint
(STATIC_SYNC_INDEX), `optimize` adds its distance rows to the solve
(weighted by pixel_sigma / median focal / sigma, as the JAX package weighs
them), `rigidity_report` measures them, and every derived volume carries it.
Duplicate (point, camera) pairs — a static corner seen from many frames —
or a grid under a third full send `optimize` to the sparse row layout.
`save`/`load` write and read the volume's tables and constraints.toml.

A volume runs on `device` (CUDA unless the caller passes another, e.g.
"cpu") in `dtype` (float32 on CUDA, float64 on the CPU unless given).
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.constraints import ConstraintSet, RigidityReport, rigidity_report
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, ImagePoints, WorldPoints
from caliscope_tpu_torch.ops.similarity import SimilarityParams, apply_similarity_to_extrinsics, umeyama
from caliscope_tpu_torch.reports import OptimizationStatus, RawErrors, ReprojectionReport
from caliscope_tpu_torch.scale import (
    CameraDistance,
    DepthObservation,
    SegmentLength,
    VolumetricScaleReport,
    compute_depth_ratios,
    compute_frame_scale_error,
    world_basis_from_up_and_forward,
)
from caliscope_tpu_torch.tracing import span

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class CaptureVolume:
    camera_array: CameraArray
    image_points: ImagePoints
    world_points: WorldPoints
    constraints: Optional[ConstraintSet] = None
    device: Optional[torch.device] = field(default=None, compare=False)
    dtype: Optional[torch.dtype] = field(default=None, compare=False)
    img_to_obj_map: np.ndarray = field(init=False, compare=False)
    _optimization_status: Optional[OptimizationStatus] = field(default=None, compare=False)

    # ---- construction / validation ----------------------------------------
    def __post_init__(self):
        device = resolve_device(self.device)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "dtype", resolve_dtype(device, self.dtype))
        object.__setattr__(self, "img_to_obj_map", self._compute_img_to_obj_map())
        self._validate_geometry()

    @property
    def optimization_status(self) -> Optional[OptimizationStatus]:
        return self._optimization_status

    @property
    def static_object_ids(self) -> frozenset[int]:
        return self.constraints.static_object_ids if self.constraints else frozenset()

    def _derived(self, **changes) -> "CaptureVolume":
        """A new volume on the same device and dtype, with the same
        constraints unless changed."""
        fields = dict(
            camera_array=self.camera_array,
            image_points=self.image_points,
            world_points=self.world_points,
            constraints=self.constraints,
            device=self.device,
            dtype=self.dtype,
        )
        fields.update(changes)
        return CaptureVolume(**fields)

    def _compute_img_to_obj_map(self) -> np.ndarray:
        """Join each image row onto its world-point row by (sync, object,
        keypoint) key; -1 where the join misses (packed int64 keys matched
        with a sorted searchsorted lookup). Observations of static objects
        use the STATIC_SYNC_INDEX sentinel as their sync key."""
        wp, ip = self.world_points, self.image_points
        obs_sync = ip.sync_index.astype(np.int64)
        static_ids = self.static_object_ids
        if static_ids:
            obs_sync = np.where(np.isin(ip.object_id, list(static_ids)), np.int64(STATIC_SYNC_INDEX), obs_sync)

        def pack(sync, obj, kp):
            # 2^21 headroom per field: sync up to ~2M, object/keypoint ids too
            return ((sync + 2) << 42) | (obj.astype(np.int64) << 21) | kp.astype(np.int64)

        world_keys = pack(wp.sync_index.astype(np.int64), wp.object_id, wp.keypoint_id)
        obs_keys = pack(obs_sync, ip.object_id, ip.keypoint_id)
        if len(world_keys) == 0:
            return np.full(len(obs_keys), -1, dtype=np.int32)
        order = np.argsort(world_keys, kind="stable")
        pos = np.searchsorted(world_keys[order], obs_keys)
        pos_clipped = np.minimum(pos, len(world_keys) - 1)
        hit = (pos < len(world_keys)) & (world_keys[order][pos_clipped] == obs_keys)
        joined = np.where(hit, order[pos_clipped], -1).astype(np.int32)
        n_miss = int((joined < 0).sum())
        if n_miss:
            logger.info(f"{n_miss}/{len(joined)} image observations lack a triangulated world point")
        return joined

    def _validate_geometry(self):
        """Reject aggregates that cannot possibly support a solve; warn when
        the observation count is thin relative to the unknowns."""
        if len(self.image_points) == 0:
            raise ValueError("CaptureVolume needs image observations; got an empty set")
        if len(self.world_points) == 0:
            raise ValueError("CaptureVolume needs world points; got an empty set")
        if not self.camera_array.posed_cameras:
            raise ValueError("CaptureVolume needs at least one posed camera")
        n_joined = int((self.img_to_obj_map >= 0).sum())
        if n_joined == 0:
            raise ValueError(
                "Not one image observation joins onto a world point — the 2D and 3D "
                "tables describe disjoint captures"
            )
        floor = 2 * len(self.world_points)
        if n_joined < floor:
            logger.warning(
                f"Thin geometry: only {n_joined} joined observations against "
                f"{len(self.world_points)} world points (multi-view work wants >= {floor})"
            )

    # ---- core solver plumbing ----------------------------------------------
    def _matched_arrays(self):
        """(mask, cam_idx (M,), obj_idx (M,), uv (M,2), views) over matched
        observations from posed cameras; views are float64 host tensors."""
        views = self.camera_array.device_views(posed_only=True, device="cpu", dtype=torch.float64)
        posed_idx = {int(c): i for i, c in enumerate(views.cam_ids)}
        posed_mask = np.isin(self.image_points.cam_id, views.cam_ids)
        mask = (self.img_to_obj_map >= 0) & posed_mask
        cam_idx = np.array([posed_idx[int(c)] for c in self.image_points.cam_id[mask]], dtype=np.int64)
        obj_idx = self.img_to_obj_map[mask].astype(np.int64)
        uv = self.image_points.img_xy[mask]
        return mask, cam_idx, obj_idx, uv, views

    def pixel_f_scale(self, px: float = 1.0) -> float:
        """Map a pixel threshold into 1/fx_init-normalized residual units."""
        focals = [c.matrix[0, 0] for c in self.camera_array.posed_cameras.values() if c.matrix is not None]
        return px / float(np.median(focals))

    @cached_property
    def reprojection_report(self) -> ReprojectionReport:
        """Pixel-space error report over matched observations, computed on
        the volume's device (cached — the volume is immutable)."""
        from caliscope_tpu_torch.ops.bucket import bucket_size, pad_rows
        from caliscope_tpu_torch.ops.reprojection import reprojection_errors
        from caliscope_tpu_torch.solvers.bundle import initial_cam9

        mask, cam_idx, obj_idx, uv, views = self._matched_arrays()
        n_total = len(self.img_to_obj_map)
        n_matched = int(mask.sum())
        if n_matched == 0:
            raise ValueError("Reprojection report needs matched observations, and this volume has none")

        def dev(a, dt=self.dtype):
            return torch.as_tensor(np.asarray(a), device=self.device, dtype=dt)

        # rows bucketed as the JAX package buckets them (filler rows: index 0, uv 0)
        Nb = bucket_size(n_matched)
        err = reprojection_errors(
            dev(initial_cam9(self.camera_array)),
            dev(pad_rows(self.world_points.xyz, bucket_size(len(self.world_points)))),
            dev(pad_rows(cam_idx, Nb), torch.int64),
            dev(pad_rows(obj_idx, Nb), torch.int64),
            dev(pad_rows(uv, Nb)),
            dev(views.K),
            dev(views.dist),
            dev(views.fisheye, torch.bool),
        )[:n_matched].cpu().numpy().astype(np.float64)
        euclid = np.sqrt(np.sum(err**2, axis=1))
        ip = self.image_points
        raw = RawErrors(
            sync_index=ip.sync_index[mask],
            cam_id=ip.cam_id[mask],
            object_id=ip.object_id[mask],
            keypoint_id=ip.keypoint_id[mask],
            error_xy=err,
        )
        by_camera = {}
        for cid in self.camera_array.posed_cameras:
            sel = raw.cam_id == cid
            by_camera[cid] = float(np.sqrt(np.mean(euclid[sel] ** 2))) if sel.any() else 0.0
        by_point = {}
        pk = np.stack([raw.object_id, raw.keypoint_id], axis=1)
        for o, k in np.unique(pk, axis=0):
            sel = (raw.object_id == o) & (raw.keypoint_id == k)
            by_point[(int(o), int(k))] = float(np.sqrt(np.mean(euclid[sel] ** 2)))
        unmatched_by_camera = {}
        for cid in self.camera_array.cameras:
            total = int(np.sum(ip.cam_id == cid))
            matched = int(np.sum((ip.cam_id == cid) & mask))
            unmatched_by_camera[cid] = total - matched
        return ReprojectionReport(
            overall_rmse=float(np.sqrt(np.mean(euclid**2))),
            by_camera=by_camera,
            by_point=by_point,
            n_unmatched_observations=n_total - n_matched,
            unmatched_rate=(n_total - n_matched) / n_total if n_total else 0.0,
            unmatched_by_camera=unmatched_by_camera,
            raw_errors=raw,
            n_observations_matched=n_matched,
            n_observations_total=n_total,
            n_cameras=len(self.camera_array.posed_cameras),
            n_points=len(self.world_points),
        )

    # ---- persistence -------------------------------------------------------
    def save(self, directory: Path | str) -> None:
        """camera_array.toml, image_points.csv, world_points.csv and, with
        constraints, constraints.toml — the JAX package's files."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        self.camera_array.to_toml(directory / "camera_array.toml")
        self.image_points.to_csv(directory / "image_points.csv")
        self.world_points.to_csv(directory / "world_points.csv")
        if self.constraints is not None:
            self.constraints.to_toml(directory / "constraints.toml")

    @classmethod
    def load(cls, directory: Path | str, device=None, dtype=None) -> "CaptureVolume":
        """The volume `save` wrote, on `device` (CUDA unless named)."""
        directory = Path(directory)
        constraints_path = directory / "constraints.toml"
        return cls(
            camera_array=CameraArray.from_toml(directory / "camera_array.toml"),
            image_points=ImagePoints.from_csv(directory / "image_points.csv"),
            world_points=WorldPoints.from_csv(directory / "world_points.csv"),
            constraints=ConstraintSet.from_toml(constraints_path) if constraints_path.exists() else None,
            device=device,
            dtype=dtype,
        )

    # ---- bootstrap ---------------------------------------------------------
    @classmethod
    def bootstrap(
        cls,
        image_points: ImagePoints,
        camera_array: CameraArray,
        constraints: Optional[ConstraintSet] = None,
        device=None,
        dtype=None,
    ) -> "CaptureVolume":
        """Pose network -> apply -> triangulate, on `device` (CUDA unless
        named); the volume gets `dtype`, the pose network the device's
        default. Static objects of `constraints` triangulate to one point
        per keypoint. Does NOT optimize."""
        from caliscope_tpu_torch.solvers.pose_network import build_pose_network, scaffold_assembly

        device = resolve_device(device)
        dtype = resolve_dtype(device, dtype)
        point_cam_ids = set(int(c) for c in np.unique(image_points.cam_id))
        missing = point_cam_ids - set(camera_array.cameras.keys())
        if missing:
            raise CalibrationError(f"ImagePoints reference cameras {missing} not in the CameraArray.")
        uncalibrated = [cid for cid, c in camera_array.cameras.items() if not c.has_intrinsics]
        if uncalibrated:
            raise CalibrationError(
                f"Cannot run extrinsic calibration -- cameras {uncalibrated} have no intrinsic calibration.\n"
                f"Run calibrate_intrinsics() for each camera first."
            )
        cameras = camera_array.copy()
        pose_network = build_pose_network(image_points, cameras, device=device)
        pose_network.apply_to(cameras)
        on = dict(device=device, dtype=dtype)
        static_ids = constraints.static_object_ids if constraints else frozenset()
        with span("bootstrap.triangulate"):
            world_points = image_points.triangulate(cameras, static_object_ids=static_ids, **on)
        volume = cls(
            camera_array=cameras, image_points=image_points, world_points=world_points, constraints=constraints, **on
        )

        # Sparse co-visibility can leave the transitively-chained network
        # inconsistent while each pairwise estimate looks fine. When the
        # chained rig reprojects poorly, rebuild from the best stereo pair's
        # cloud (scaffold + resection) and keep whichever rig is better.
        if volume.reprojection_report.overall_rmse > 20.0:
            rebuilt = scaffold_assembly(image_points, cameras, pose_network, static_object_ids=static_ids, **on)
            if rebuilt is not None and len(rebuilt.posed_cameras) >= min(len(cameras.posed_cameras), 2):
                world2 = image_points.triangulate(rebuilt, static_object_ids=static_ids, **on)
                try:
                    candidate = cls(
                        camera_array=rebuilt, image_points=image_points, world_points=world2,
                        constraints=constraints, **on,
                    )
                    # prefer the rig that poses more cameras; break ties on RMSE
                    n_new, n_old = len(rebuilt.posed_cameras), len(volume.camera_array.posed_cameras)
                    if n_new > n_old or (
                        n_new == n_old
                        and candidate.reprojection_report.overall_rmse < volume.reprojection_report.overall_rmse
                    ):
                        logger.warning(
                            f"Bootstrap: scaffold re-assembly improved reprojection RMSE "
                            f"{volume.reprojection_report.overall_rmse:.1f} -> "
                            f"{candidate.reprojection_report.overall_rmse:.1f} px"
                        )
                        volume = candidate
                except ValueError:
                    pass

        return _repair_bootstrap_outlier_cameras(volume, static_ids)

    # ---- bundle adjustment --------------------------------------------------
    def ba_problem(self, refine_intrinsics: bool = False, use_constraints: bool = True, pixel_sigma: float = 1.0):
        """The bundle-adjustment problem `optimize` solves for this volume,
        on its device: (problem, start cameras (C,9), start points (Pb,3)),
        with the counts bucketed, the layout chosen and the constraint rows
        weighted as `optimize` does it."""
        from caliscope_tpu_torch.ops.bucket import bucket_size, pad_rows
        from caliscope_tpu_torch.solvers.bundle import initial_cam9, make_dense_problem, make_problem

        _mask, cam_idx, obj_idx, uv, views = self._matched_arrays()
        K, dist, fisheye = views.K.numpy(), views.dist.numpy(), views.fisheye.numpy()

        constraint_arrays = None
        if use_constraints and self.constraints is not None:
            arrays = self.constraints.compile_arrays(self.world_points)
            if arrays is not None:
                pa_idx, pa_w, pb_idx, pb_w, dists, sigmas = arrays
                f_median = float(np.median(K[:, 0, 0]))
                weights = (pixel_sigma / f_median) / sigmas
                constraint_arrays = (pa_idx, pa_w, pb_idx, pb_w, dists, weights)
                logger.info(f"Adding {len(dists)} constraint rows (f_median={f_median:.0f}, pixel_sigma={pixel_sigma})")

        # Bucket observation and point counts as the JAX package does (one
        # problem shape per quarter octave). Padding rows carry
        # obs_mask=False and point at the reserved tail slot; padding points
        # start at the cloud centroid and are pinned by the solver's
        # zero-diagonal prior, so their update is exactly zero.
        N_real, P_real = len(uv), len(self.world_points)
        Nb, Pb = bucket_size(N_real, fine=True), bucket_size(P_real + 1, fine=True)
        X0 = np.empty((Pb, 3))
        X0[:P_real] = self.world_points.xyz
        X0[P_real:] = self.world_points.xyz.mean(axis=0)

        # Layout choice: the dense (P, C) grid needs unique (point, camera)
        # pairs and pays off when the grid is at least a third full; static
        # objects (many frames onto one point) and sparse co-visibility take
        # the sparse row layout
        n_cams = len(K)
        pair_key = obj_idx.astype(np.int64) * n_cams + cam_idx
        unique_pairs = len(np.unique(pair_key)) == len(pair_key)
        common = dict(refine_intrinsics=refine_intrinsics, constraints=constraint_arrays, dtype=self.dtype, device=self.device)
        if unique_pairs and Pb * n_cams <= 3 * max(N_real, 1):
            problem = make_dense_problem(cam_idx, obj_idx, uv, K, dist, fisheye, n_points=Pb, **common)
        else:
            obs_mask = np.zeros(Nb, bool)
            obs_mask[:N_real] = True
            problem = make_problem(
                pad_rows(cam_idx, Nb), pad_rows(obj_idx, Nb, fill=Pb - 1), pad_rows(uv, Nb), K, dist, fisheye,
                obs_mask=obs_mask, **common,
            )
        return problem, initial_cam9(self.camera_array), X0

    def optimize(
        self,
        ftol: float = 1e-8,
        max_nfev: int | None = None,
        strict: bool = True,
        use_constraints: bool = True,
        pixel_sigma: float = 1.0,
        *,
        refine_intrinsics: bool = False,
        loss: str = "linear",
        f_scale: float = 1.0,
        solver: str = "auto",
        shard: str = "auto",
        bake_problem: bool = False,
        fused_schur: bool | None = None,
    ) -> "CaptureVolume":
        """Bundle adjustment. Extrinsics-only by default; refine_intrinsics
        adds the [s, k1, k2] block per camera. With use_constraints and a
        constraint set, its firing distance rows join the solve at weight
        (pixel_sigma / median focal) / sigma.

        shard: passed to lm_solve as BAConfig.shard — 'auto' (default)
        shards the solve over an initialised torch.distributed process
        group of more than one rank when the problem has at least
        BAConfig.shard_min_obs observations, 'always' over any initialised
        group, 'never' keeps one placement. Every rank of the group calls
        optimize on the same volume; each gets the whole result.
        bake_problem: passed to lm_solve as BAConfig.bake_problem — on CUDA
        the LM iteration runs as CUDA graphs captured on the first baked
        solve of a problem and cached on it (solvers/baked.py); the answers
        are those of an unbaked solve. Each optimize builds a new problem,
        so here every baked solve captures anew.
        fused_schur: passed to lm_solve — None (default) assembles the Schur
        system with the CUDA kernel whenever the problem qualifies, False
        never, True always (raising where the kernel cannot run)."""
        from caliscope_tpu_torch.solvers.bundle import BAConfig, bound_warnings, lm_solve

        with span("ba.solve"):
            with span("ba.setup"):
                problem, cam9_0, X0 = self.ba_problem(refine_intrinsics, use_constraints, pixel_sigma)
            P_real = len(self.world_points)
            config = BAConfig(
                loss=loss,
                f_scale=f_scale,
                max_iter=max_nfev if max_nfev is not None else 200,
                ftol=ftol,
                solver=solver,
                shard=shard,
                bake_problem=bake_problem,
            )
            logger.info(f"Beginning bundle adjustment on {len(self.image_points)} observations ({X0.shape[0]} bucketed points)")
            result = lm_solve(problem, cam9_0, X0, config, fused_schur=fused_schur)

            termination = "converged_ftol" if result.converged else "max_iterations"
            if strict and not result.converged:
                raise CalibrationError(
                    f"Bundle adjustment did not converge: {termination}\n"
                    f"Pass strict=False to suppress this error and inspect the result."
                )

            with span("ba.finish"):
                new_cameras = self.camera_array.copy()
                for i, cid in enumerate(sorted(new_cameras.posed_cameras.keys())):
                    cam = new_cameras.cameras[cid]
                    cam.extrinsics_from_vector(result.cam9[i, :6])
                    if refine_intrinsics:
                        s, k1, k2 = result.cam9[i, 6:]
                        cam.matrix = cam.matrix.copy()
                        cam.matrix[0, 0] *= s
                        cam.matrix[1, 1] *= s
                        d = cam.distortions.copy()
                        d[0], d[1] = k1, k2
                        cam.distortions = d

                status = OptimizationStatus(
                    converged=result.converged,
                    termination_reason=termination,
                    iterations=result.n_iterations,
                    final_cost=result.cost_final,
                    bound_warnings=tuple(bound_warnings(result.cam9)) if refine_intrinsics else (),
                )
                return self._derived(
                    camera_array=new_cameras,
                    world_points=self.world_points.with_xyz(result.X[:P_real].cpu().numpy().astype(np.float64)),
                    _optimization_status=status,
                )

    # ---- rigidity / scale QA ------------------------------------------------
    def rigidity_report(self) -> RigidityReport:
        return rigidity_report(self.constraints, self.world_points)

    def compute_volumetric_scale_accuracy(self) -> VolumetricScaleReport:
        """Per-(frame, object) pairwise-distance accuracy vs obj_loc ground
        truth (reference capture_volume.py:755-831)."""
        ip = self.image_points
        has_obj = np.isfinite(ip.obj_loc).all(axis=1)
        matched = self.img_to_obj_map >= 0
        usable = has_obj & matched
        if not usable.any():
            return VolumetricScaleReport.empty()
        frame_errors = []
        keys = np.stack([ip.sync_index[usable], ip.object_id[usable]], axis=1)
        rows = np.where(usable)[0]
        for s, o in np.unique(keys, axis=0):
            sel = rows[(keys[:, 0] == s) & (keys[:, 1] == o)]
            kp = ip.keypoint_id[sel]
            uniq_kp, first = np.unique(kp, return_index=True)
            if len(uniq_kp) < 2:
                continue
            obj_pts = ip.obj_loc[sel][first]
            world_rows = self.img_to_obj_map[sel][first]
            world_pts = self.world_points.xyz[world_rows]
            n_cams = len(np.unique(ip.cam_id[sel]))
            try:
                frame_errors.append(compute_frame_scale_error(world_pts, obj_pts, int(s), int(o), n_cams))
            except ValueError as e:
                logger.debug(f"Skipping sync {s} object {o}: {e}")
        return VolumetricScaleReport(
            frame_errors=tuple(frame_errors),
            static_object_ids=self.constraints.static_object_ids if self.constraints else frozenset(),
        )

    def depth_ratios(self) -> dict[int, float]:
        return compute_depth_ratios(self.camera_array, self.world_points)

    # ---- filtering ----------------------------------------------------------
    def _filter_by_thresholds(self, thresholds: dict[int, float], min_per_camera: int) -> "CaptureVolume":
        """Per-camera error thresholds with a keep-at-least floor; prunes
        orphaned world points, preserving static points that retain
        observations."""
        raw = self.reprojection_report.raw_errors
        euclid = raw.euclidean_error
        thr = np.array([thresholds.get(int(c), np.inf) for c in raw.cam_id])
        keep = euclid <= thr
        for cid in np.unique(raw.cam_id):
            sel = raw.cam_id == cid
            n_keep, n_total = int(keep[sel].sum()), int(sel.sum())
            if n_keep < min_per_camera and n_keep < n_total:
                n_needed = min(min_per_camera, n_total) - n_keep
                dropped = euclid[sel & ~keep]
                if len(dropped) >= n_needed:
                    add_thr = np.sort(dropped)[n_needed - 1]
                    keep[sel] = euclid[sel] <= add_thr

        keep_keys = {
            (int(s), int(c), int(o), int(k))
            for s, c, o, k in zip(raw.sync_index[keep], raw.cam_id[keep], raw.object_id[keep], raw.keypoint_id[keep])
        }
        ip = self.image_points
        ip_keep = np.array(
            [
                (int(s), int(c), int(o), int(k)) in keep_keys
                for s, c, o, k in zip(ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id)
            ]
        )
        new_ip = ip.select(ip_keep)

        # prune orphaned world points
        obs_keys = {
            (int(s), int(o), int(k)) for s, o, k in zip(new_ip.sync_index, new_ip.object_id, new_ip.keypoint_id)
        }
        static_obs_keys = {(int(o), int(k)) for o, k in zip(new_ip.object_id, new_ip.keypoint_id)}
        wp = self.world_points
        wp_keep = np.array(
            [
                (
                    ((int(o), int(k)) in static_obs_keys)
                    if int(s) == STATIC_SYNC_INDEX
                    else ((int(s), int(o), int(k)) in obs_keys)
                )
                for s, o, k in zip(wp.sync_index, wp.object_id, wp.keypoint_id)
            ]
        )
        return self._derived(image_points=new_ip, world_points=wp.select(wp_keep))

    def filter_by_absolute_error(self, max_pixels: float, min_per_camera: int = 10) -> "CaptureVolume":
        if max_pixels <= 0:
            raise ValueError(f"A non-positive pixel threshold ({max_pixels}) would drop every observation")
        if min_per_camera < 1:
            raise ValueError(f"The per-camera safety floor must keep at least one observation (got {min_per_camera})")
        thresholds = {cid: max_pixels for cid in self.camera_array.posed_cameras}
        return self._filter_by_thresholds(thresholds, min_per_camera)

    def filter_by_percentile_error(
        self,
        percentile: float,
        scope: Literal["per_camera", "overall"] = "per_camera",
        min_per_camera: int = 10,
    ) -> "CaptureVolume":
        """Remove the worst N% of observations by reprojection error."""
        if not (0 < percentile <= 100):
            raise ValueError(f"Filter percentile {percentile} falls outside (0, 100]")
        if min_per_camera < 1:
            raise ValueError(f"The per-camera safety floor must keep at least one observation (got {min_per_camera})")
        with span("ba.filter"):
            raw = self.reprojection_report.raw_errors
            euclid = raw.euclidean_error
            keep_pct = 100 - percentile
            if scope == "per_camera":
                thresholds = {}
                for cid in self.camera_array.posed_cameras:
                    errs = euclid[raw.cam_id == cid]
                    thresholds[cid] = float(np.percentile(errs, keep_pct)) if len(errs) else float(np.inf)
            elif scope == "overall":
                g = float(np.percentile(euclid, keep_pct))
                thresholds = {cid: g for cid in self.camera_array.posed_cameras}
            else:
                raise ValueError(f"Unknown filter scope {scope!r}; use per_camera or overall")
            return self._filter_by_thresholds(thresholds, min_per_camera)

    # ---- anchoring ----------------------------------------------------------
    def _apply_similarity(self, params: SimilarityParams) -> "CaptureVolume":
        """The volume moved by a world-frame similarity (host, float64)."""
        posed_ids = sorted(self.camera_array.posed_cameras)
        R_new, t_new = apply_similarity_to_extrinsics(
            params.scale,
            np.asarray(params.rotation),
            np.asarray(params.translation),
            np.stack([self.camera_array.cameras[c].rotation for c in posed_ids]),
            np.stack([self.camera_array.cameras[c].translation for c in posed_ids]),
        )
        new_cameras = self.camera_array.copy()
        for i, cid in enumerate(posed_ids):
            new_cameras.cameras[cid].rotation = R_new[i].numpy()
            new_cameras.cameras[cid].translation = t_new[i].numpy()
        return self._derived(
            camera_array=new_cameras,
            world_points=self.world_points.with_xyz(params.apply(self.world_points.xyz)),
            _optimization_status=self._optimization_status,
        )

    def align_to_object(self, sync_index: int | None, object_id: int | None = None) -> "CaptureVolume":
        """Rigid-align the volume to a marker's local frame: marker center at
        origin, axes as printed (right-handed, Z out of the face). sync=None
        only for static markers."""
        ip = self.image_points
        static_ids = self.static_object_ids
        if sync_index is None:
            if object_id is None:
                raise ValueError("Omitting sync_index requires naming the static object_id to anchor on")
            if object_id not in static_ids:
                raise ValueError(
                    f"Anchoring without a sync_index works only on STATIC markers; object {object_id} moves between frames"
                )
        sel = np.ones(len(ip), bool) if sync_index is None else ip.sync_index == sync_index
        if not sel.any():
            raise ValueError(f"Nothing was observed at sync_index={sync_index}; pick a frame the marker appears in")
        if object_id is None:
            objs = np.unique(ip.object_id[sel])
            if len(objs) > 1:
                raise ValueError(
                    f"Multiple markers present at sync_index {sync_index}; specify object_id "
                    f"(available: {sorted(int(o) for o in objs)})"
                )
            object_id = int(objs[0])
        sel &= ip.object_id == object_id
        world_si = STATIC_SYNC_INDEX if object_id in static_ids else (sync_index if sync_index is not None else 0)

        # unique (keypoint -> obj_loc) among selected observations
        kp_sel = ip.keypoint_id[sel]
        ol_sel = ip.obj_loc[sel].copy()
        if np.isnan(ol_sel[:, 2]).all() and np.isfinite(ol_sel[:, :2]).any():
            logger.info("No z column in the object geometry; treating the target as the z=0 plane")
            ol_sel[:, 2] = 0.0
        uniq_kp, first = np.unique(kp_sel, return_index=True)
        obj_map = {int(k): ol_sel[i] for k, i in zip(uniq_kp, first) if np.isfinite(ol_sel[i]).all()}

        wp = self.world_points
        wsel = (wp.sync_index == world_si) & (wp.object_id == object_id)
        src, dst = [], []
        for i in np.where(wsel)[0]:
            k = int(wp.keypoint_id[i])
            if k in obj_map:
                src.append(wp.xyz[i])
                dst.append(obj_map[k])
        if len(src) < 3:
            raise ValueError(f"Need at least 3 valid correspondences for object_id={object_id}, got {len(src)}")
        s, R, t = umeyama(np.asarray(src), np.asarray(dst), with_scale=False)
        params = SimilarityParams(float(s), R.numpy(), t.numpy())
        logger.info(
            f"Estimated alignment: scale={params.scale:.6f}, translation={params.translation}, "
            f"rotation_det={np.linalg.det(params.rotation):.6f}"
        )
        return self._apply_similarity(params)

    @property
    def unique_sync_indices(self) -> np.ndarray:
        return np.sort(np.unique(self.world_points.sync_index))

    def rotate(self, axis: Literal["x", "y", "z"], angle_degrees: float) -> "CaptureVolume":
        """Right-hand-rule rotation of the whole coordinate system."""
        a = np.radians(angle_degrees)
        c, s = np.cos(a), np.sin(a)
        if axis == "x":
            R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        elif axis == "y":
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        elif axis == "z":
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        else:
            raise ValueError(f"Unknown rotation axis {axis!r} (expected one of x/y/z)")
        return self._apply_similarity(SimilarityParams(1.0, R, np.zeros(3)))

    def translate(self, x: float = 0.0, y: float = 0.0, z: float = 0.0) -> "CaptureVolume":
        return self._apply_similarity(SimilarityParams(1.0, np.eye(3), np.array([x, y, z], float)))

    def _anchor_cam_id(self) -> int:
        posed = self.camera_array.posed_cameras
        if not posed:
            raise ValueError("Anchoring needs at least one posed camera, but none carry extrinsics yet")
        return min(posed)

    def _camera_center(self, cam_id: int) -> np.ndarray:
        cam = self.camera_array.cameras[cam_id]
        if cam.rotation is None or cam.translation is None:
            raise ValueError(f"Camera {cam_id} carries no extrinsics, so its optical center is undefined")
        return -cam.rotation.T @ cam.translation

    def scaled(self, *cues: CameraDistance | SegmentLength | DepthObservation) -> "CaptureVolume":
        """Set the volume's metric scale from one or more measurement cues.

        Each usable cue contributes a pair (length in current solver units,
        length in meters) plus a meter-space uncertainty; the global scale is
        the weighted least-squares solution of ``meters ~= scale *
        solver_units`` with weights 1/sigma^2. Depth cues that cannot be tied
        to a unique world point are dropped with a warning; cue pairs whose
        individually-implied scales sit more than two combined sigmas apart
        trigger a disagreement warning.
        """
        if not cues:
            raise ValueError("scaled() needs at least one metric cue.")
        units, meters, sigmas = [], [], []
        dropped: dict[str, int] = {}
        n_depth_cues = 0
        for cue in cues:
            if isinstance(cue, CameraDistance):
                evidence = self._measure_camera_gap(cue)
            elif isinstance(cue, SegmentLength):
                evidence = self._measure_segment(cue)
            elif isinstance(cue, DepthObservation):
                n_depth_cues += 1
                evidence = self._measure_depth(cue)
                if isinstance(evidence, str):
                    dropped[evidence] = dropped.get(evidence, 0) + 1
                    continue
            else:
                raise TypeError(f"Not a scale cue: {type(cue).__name__}")
            units.append(evidence[0])
            meters.append(evidence[1])
            sigmas.append(evidence[2])
        if dropped:
            detail = "; ".join(f"{n}x {why}" for why, n in sorted(dropped.items()))
            warnings.warn(
                f"Ignored {sum(dropped.values())} of {n_depth_cues} depth cues ({detail}).",
                stacklevel=2,
            )
        if not units:
            raise ValueError(f"None of the {len(cues)} scale cues could be measured in this volume.")
        u, m, sg = np.asarray(units), np.asarray(meters), np.asarray(sigmas)
        w = 1.0 / np.square(sg)
        scale = float((w * m * u).sum() / (w * u * u).sum())
        self._warn_on_scale_disagreement(u, m, sg)
        return self._apply_similarity(SimilarityParams(scale, np.eye(3), np.zeros(3)))

    @staticmethod
    def _warn_on_scale_disagreement(u: np.ndarray, m: np.ndarray, sg: np.ndarray) -> None:
        """Pairwise consistency check on the per-cue implied scales."""
        if len(u) < 2:
            return
        implied = m / u
        implied_sigma = sg / u
        ii, jj = np.triu_indices(len(u), k=1)
        tolerance = 2.0 * np.hypot(implied_sigma[ii], implied_sigma[jj])
        conflicting = np.abs(implied[ii] - implied[jj]) > tolerance
        for i, j, tol in zip(ii[conflicting], jj[conflicting], tolerance[conflicting]):
            warnings.warn(
                f"Scale cues {i} and {j} disagree: they imply {implied[i]:.6g} vs "
                f"{implied[j]:.6g}, a gap beyond the combined 2-sigma tolerance "
                f"of {tol:.6g}.",
                stacklevel=3,
            )

    def _measure_camera_gap(self, cue: CameraDistance) -> tuple[float, float, float]:
        posed = self.camera_array.posed_cameras
        unposed = [cid for cid in (cue.cam_a, cue.cam_b) if cid not in posed]
        if unposed:
            raise ValueError(f"CameraDistance cue needs posed cameras, but {unposed} have no pose.")
        gap = float(np.linalg.norm(self._camera_center(cue.cam_a) - self._camera_center(cue.cam_b)))
        if gap == 0.0:
            raise ValueError(
                f"Cameras {cue.cam_a} and {cue.cam_b} share a center; the distance cue carries no scale information."
            )
        return gap, float(cue.meters), float(cue.sigma_m)

    def _measure_segment(self, cue: SegmentLength) -> tuple[float, float, float]:
        """Median triangulated length of the (kp_a, kp_b) segment over every
        (sync, object) group where both endpoints exist."""
        wp = self.world_points
        is_a = wp.keypoint_id == cue.keypoint_id_a
        is_b = wp.keypoint_id == cue.keypoint_id_b
        group = np.stack([wp.sync_index, wp.object_id], axis=1)
        _, group_id = np.unique(group, axis=0, return_inverse=True)
        n_groups = int(group_id.max()) + 1 if len(group_id) else 0
        a_row = np.full(n_groups, -1)
        b_row = np.full(n_groups, -1)
        a_row[group_id[is_a]] = np.where(is_a)[0]
        b_row[group_id[is_b]] = np.where(is_b)[0]
        both = (a_row >= 0) & (b_row >= 0)
        if not both.any():
            raise ValueError(
                f"SegmentLength cue: keypoints {cue.keypoint_id_a} and "
                f"{cue.keypoint_id_b} are never triangulated together in any frame."
            )
        lengths = np.linalg.norm(wp.xyz[a_row[both]] - wp.xyz[b_row[both]], axis=1)
        return float(np.median(lengths)), float(cue.meters), float(cue.sigma_m)

    def _measure_depth(self, cue: DepthObservation) -> tuple[float, float, float] | str:
        """Evidence triple, or a human-readable reason the cue is unusable."""
        cam = self.camera_array.cameras.get(cue.cam_id)
        if cam is None or cam.rotation is None or cam.translation is None:
            return "camera has no pose"
        wp = self.world_points
        rows = np.flatnonzero((wp.sync_index == cue.sync_index) & (wp.keypoint_id == cue.keypoint_id))
        if len(rows) == 0:
            return "keypoint not triangulated at that sync index"
        if len(rows) > 1:
            return "keypoint matches several world points"
        z_cam = float((cam.rotation @ wp.xyz[rows[0]] + cam.translation)[2])
        if z_cam <= 0.0:
            return "point sits behind the camera"
        return z_cam, float(cue.depth_m), float(cue.sigma_m)

    def oriented(self, up: dict[int, np.ndarray]) -> "CaptureVolume":
        """Rotate so the consensus per-camera vertical becomes +Z; yaw fixed
        by the anchor camera's optical axis -> +Y."""
        if not up:
            raise ValueError("oriented() needs an up vector for at least one camera.")
        cam_ids = list(up.keys())
        for cid in cam_ids:
            cam = self.camera_array.cameras.get(cid)
            if cam is None or cam.rotation is None:
                raise ValueError(f"oriented(): camera {cid} has no pose to rotate an up vector through.")
        # rows: each camera's claimed vertical, expressed in world coordinates
        verticals = np.stack(
            [self.camera_array.cameras[cid].rotation.T @ np.asarray(v, float) for cid, v in up.items()]
        )
        pooled = verticals.mean(axis=0)
        pooled_len = float(np.linalg.norm(pooled))
        if pooled_len < 1e-9:
            raise ValueError("The per-camera verticals cancel out; no usable consensus up direction.")
        up_world = pooled / pooled_len
        unit = verticals / np.linalg.norm(verticals, axis=1, keepdims=True)
        spread_deg = np.degrees(np.arccos(np.clip(unit @ up_world, -1.0, 1.0)))
        logger.info(
            "Per-camera deviation from the pooled vertical (deg): %s",
            {cid: round(float(d), 2) for cid, d in zip(cam_ids, spread_deg)},
        )
        anchor = self.camera_array.cameras[self._anchor_cam_id()]
        gaze = anchor.rotation.T @ np.array([0.0, 0.0, 1.0])
        basis = world_basis_from_up_and_forward(up_world, gaze)
        return self._apply_similarity(SimilarityParams(1.0, basis, np.zeros(3)))

    def grounded(
        self, mode: Literal["lowest_point"] = "lowest_point", *, lowest_point_height_m: float = 0.0
    ) -> "CaptureVolume":
        """Floor at Z=0 (robust 1st-percentile order statistic of world Z) and
        XY origin under the anchor camera. Call after oriented()."""
        if mode != "lowest_point":
            raise ValueError(f"Unsupported grounding mode {mode!r}; 'lowest_point' is the only strategy implemented")
        min_z = float(np.percentile(self.world_points.xyz[:, 2], 1.0, method="lower"))
        center = self._camera_center(self._anchor_cam_id())
        return self.translate(x=-center[0], y=-center[1], z=-min_z + lowest_point_height_m)

    def centered(self) -> "CaptureVolume":
        """XY origin at the centroid of posed camera centers; Z untouched."""
        rig_xy = np.stack([self._camera_center(cid)[:2] for cid in self.camera_array.posed_cameras]).mean(axis=0)
        return self.translate(x=-rig_xy[0], y=-rig_xy[1])


def _repair_bootstrap_outlier_cameras(
    volume: CaptureVolume,
    static_ids: frozenset[int],
    max_passes: int = 2,
    rel_factor: float = 4.0,
    abs_floor_px: float = 10.0,
) -> CaptureVolume:
    """Structure-based repair of badly-posed cameras after bootstrap.

    Sparse co-visibility leaves some camera pairs with too few relative-pose
    samples to reject planar-PnP flip contamination statistically (the IPPE
    two-fold ambiguity: both lobes fit a single view equally well). The
    repair is the multi-view disambiguator: triangulate a cloud from the
    mutually-consistent cameras, then re-resect each outlier camera against
    that cloud with PnP-RANSAC on the volume's device."""
    from caliscope_tpu_torch.solvers.pose_network import resect_against_cloud

    on = dict(device=volume.device, dtype=volume.dtype)
    for _ in range(max_passes):
        rep = volume.reprojection_report
        by_cam = {c: r for c, r in rep.by_camera.items() if r > 0}
        if len(by_cam) < 2:
            return volume
        best = min(by_cam.values())
        threshold = max(rel_factor * best, abs_floor_px)
        bad = [c for c, r in by_cam.items() if r > threshold]
        # cameras with observations that the pose network could not place at
        # all (no surviving pairs) are resected here too
        observed = {int(c) for c in np.unique(volume.image_points.cam_id)}
        unposed = sorted(
            observed & {c for c, cam in volume.camera_array.cameras.items() if not cam.is_posed and not cam.ignore}
        )
        bad = sorted(set(bad) | set(unposed))
        good = [c for c in by_cam if c not in bad]
        if not bad or len(good) < 2:
            return volume
        logger.warning(
            f"Bootstrap repair: cameras {bad} have reprojection RMSE above {threshold:.1f}px "
            f"(best {best:.2f}px); re-resecting against the {len(good)}-camera cloud."
        )
        ip = volume.image_points
        cloud = ip.select(np.isin(ip.cam_id, good)).triangulate(volume.camera_array, static_object_ids=static_ids, **on)

        new_cameras = volume.camera_array.copy()
        repaired = False
        for cid in bad:
            cam = new_cameras.cameras[cid]
            result = resect_against_cloud(ip, cam, cloud, static_ids, volume.device, cid)
            if result is None:
                continue
            cam.rotation, cam.translation, _med = result
            repaired = True
        if not repaired:
            return volume
        world = volume.image_points.triangulate(new_cameras, static_object_ids=static_ids, **on)
        volume = volume._derived(camera_array=new_cameras, world_points=world)
    return volume
