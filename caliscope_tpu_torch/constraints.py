"""Rigidity constraints: targets -> distance constraints -> BA arrays.

Port of caliscope_tpu/constraints.py, host numpy like the original and
line for line where it can be: `ConstraintSet.compile_arrays` must hand the
solver the same rows in the same order (tests/test_torch_constraints.py
holds it bit for bit), since every point reduction downstream sums in row
order.

The constraint set compiles to the BA solver's width-4 weighted endpoint
groups (solvers/bundle.py con_* arrays): a corner endpoint is one point
index repeated with weights [1,0,0,0]; a centroid endpoint is a marker's
four corner rows at weight 0.25 each. Distance rows along a board's grid
(local truss plus the braces among its four extreme corners) pin its shape
against folds; a thick two-sided board adds per-corner front-to-back ties
and their diagonal braces. The rigidity report measures every firing
constraint's actual against its expected distance in one vectorized pass.

`from_marker_set` and `from_chessboard` read their targets by attribute
(`markers`, `links`, `mirror_pairs`; `square_size_m`, `object_points()`),
so any object with those attributes serves.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from pathlib import Path

import numpy as np

from caliscope_tpu_torch import persistence
from caliscope_tpu_torch.exceptions import PersistenceError
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, ImagePoints, WorldPoints

DEFAULT_SIGMA_M = 0.002
DEFAULT_CENTER_SIGMA_M = 0.005
DEFAULT_THICKNESS_SIGMA_M = 0.0005


@dataclass(frozen=True)
class DistanceConstraint:
    object_id_a: int
    keypoint_id_a: int
    object_id_b: int
    keypoint_id_b: int
    distance: float
    sigma: float


@dataclass(frozen=True)
class CentroidDistanceConstraint:
    """Distance between two markers' corner centroids (keypoints 0..3).

    Pins only the separation of the centroids; each marker's intra-marker
    constraints keep its own shape pinned.
    """

    object_id_a: int
    object_id_b: int
    distance: float
    sigma: float


@dataclass(frozen=True)
class PointRemap:
    """Rewrites one observed (object_id, keypoint_id) to another identity.

    Compiled from zero-thickness MirrorPairs so both faces of a thin board
    contribute to the same triangulated world point; carries marker A's
    baked-in obj_loc.
    """

    object_id_from: int
    keypoint_id_from: int
    object_id_to: int
    keypoint_id_to: int
    obj_loc_x: float
    obj_loc_y: float
    obj_loc_z: float


@dataclass(frozen=True)
class ConstraintSet:
    distances: tuple[DistanceConstraint, ...]
    static_object_ids: frozenset[int]
    centroid_distances: tuple[CentroidDistanceConstraint, ...] = ()
    point_remaps: tuple[PointRemap, ...] = ()
    # Set only by from_charuco: declares the closed identity universe
    # ({0} or {0, 1}) so the pipeline can fail loudly on a thickness mismatch.
    back_face_thickness_m: float | None = None

    def without_objects(self, object_ids: frozenset[int]) -> "ConstraintSet":
        """A copy with every constraint touching the given objects removed
        (remaps and thickness declaration untouched)."""
        return ConstraintSet(
            distances=tuple(
                d
                for d in self.distances
                if d.object_id_a not in object_ids and d.object_id_b not in object_ids
            ),
            static_object_ids=self.static_object_ids - object_ids,
            centroid_distances=tuple(
                c
                for c in self.centroid_distances
                if c.object_id_a not in object_ids and c.object_id_b not in object_ids
            ),
            point_remaps=self.point_remaps,
            back_face_thickness_m=self.back_face_thickness_m,
        )

    # ---- compilers ----------------------------------------------------------
    @classmethod
    def from_marker_set(
        cls,
        marker_set,
        sigma_m: float = DEFAULT_SIGMA_M,
        center_sigma_m: float = DEFAULT_CENTER_SIGMA_M,
    ) -> "ConstraintSet":
        """6 intra-marker constraints per marker (4 edges + 2 diagonals),
        links pass through (corner -> DistanceConstraint, center ->
        CentroidDistanceConstraint), mirror pairs compile to 4 thickness
        constraints (thick) or 4 PointRemaps (zero-thickness)."""
        remapped = {p.marker_b for p in marker_set.mirror_pairs if p.is_zero_thickness}
        constraints: list[DistanceConstraint] = []
        for mid, marker in marker_set.markers.items():
            if mid in remapped:
                continue
            corners = marker.corners
            for i in range(4):
                for j in range(i + 1, 4):
                    constraints.append(
                        DistanceConstraint(mid, i, mid, j, float(np.linalg.norm(corners[i] - corners[j])), sigma_m)
                    )

        centroids: list[CentroidDistanceConstraint] = []
        for link in marker_set.links:
            if link.is_center:
                centroids.append(
                    CentroidDistanceConstraint(
                        link.marker_a, link.marker_b, link.distance_m,
                        link.sigma_m if link.sigma_m is not None else center_sigma_m,
                    )
                )
            else:
                constraints.append(
                    DistanceConstraint(
                        link.marker_a, link.corner_a, link.marker_b, link.corner_b,
                        link.distance_m, link.sigma_m if link.sigma_m is not None else sigma_m,
                    )
                )

        remaps: list[PointRemap] = []
        for pair in marker_set.mirror_pairs:
            if pair.is_zero_thickness:
                marker_a = marker_set.markers[pair.marker_a]
                for ca, cb in pair.corner_mapping:
                    loc = marker_a.corners[ca]
                    remaps.append(
                        PointRemap(pair.marker_b, cb, pair.marker_a, ca, float(loc[0]), float(loc[1]), float(loc[2]))
                    )
            else:
                for ca, cb in pair.corner_mapping:
                    constraints.append(
                        DistanceConstraint(
                            pair.marker_a, ca, pair.marker_b, cb, pair.thickness_m,
                            pair.sigma_m if pair.sigma_m is not None else sigma_m,
                        )
                    )

        static_ids = frozenset(m for m, mk in marker_set.markers.items() if mk.static and m not in remapped)
        return cls(tuple(constraints), static_ids, tuple(centroids), tuple(remaps))

    @staticmethod
    def _truss_constraints(corners: np.ndarray, spacing: float, sigma_m: float, object_id: int = 0):
        """Local truss (neighbor edges + both cell diagonals) + 6 braces among
        the 4 extreme corners.

        Neighbor + diagonal
        distances are invariant under a fold along any grid line; the global
        braces cross every fold line and kill those modes. Corners are located
        on the grid by rounding coordinates to the nearest spacing multiple,
        so layout is recovered from geometry, not assumed id order.
        """
        xk = np.round(corners[:, 0] / spacing).astype(np.int64)
        yk = np.round(corners[:, 1] / spacing).astype(np.int64)
        edges: list[tuple[int, int]] = []
        rows: dict[int, list[tuple[int, int]]] = {}
        for idx, y in enumerate(yk):
            rows.setdefault(int(y), []).append((int(xk[idx]), idx))
        for pts in rows.values():
            pts.sort()
            edges += [(a, b) for (_, a), (_, b) in zip(pts, pts[1:])]
        cols: dict[int, list[tuple[int, int]]] = {}
        for idx, x in enumerate(xk):
            cols.setdefault(int(x), []).append((int(yk[idx]), idx))
        for pts in cols.values():
            pts.sort()
            edges += [(a, b) for (_, a), (_, b) in zip(pts, pts[1:])]
        coord = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(xk, yk))}
        for i, (x, y) in enumerate(zip(xk, yk)):
            right, up, diag = coord.get((x + 1, y)), coord.get((x, y + 1)), coord.get((x + 1, y + 1))
            if right is not None and up is not None and diag is not None:
                edges.append((i, diag))
                edges.append((right, up))
        extremes = [
            coord[(xk.min(), yk.min())],
            coord[(xk.min(), yk.max())],
            coord[(xk.max(), yk.min())],
            coord[(xk.max(), yk.max())],
        ]
        edges += list(combinations(extremes, 2))
        return tuple(
            DistanceConstraint(object_id, a, object_id, b, float(np.linalg.norm(corners[a] - corners[b])), sigma_m)
            for a, b in edges
        )

    @staticmethod
    def _cross_face_constraints(corners: np.ndarray, spacing: float, thickness_m: float, sigma_m: float):
        """Per-corner front<->back ties at the thickness plus right/down
        braces at hypot(spacing, thickness) that kill the 2-DoF lateral shear
        null space the ties alone leave."""
        xk = np.round(corners[:, 0] / spacing).astype(np.int64)
        yk = np.round(corners[:, 1] / spacing).astype(np.int64)
        coord = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(xk, yk))}
        brace = float(np.hypot(spacing, thickness_m))
        rows: list[DistanceConstraint] = []
        for i, (x, y) in enumerate(zip(xk, yk)):
            rows.append(DistanceConstraint(0, i, 1, i, thickness_m, sigma_m))
            for nb in (coord.get((x + 1, y)), coord.get((x, y + 1))):
                if nb is not None:
                    rows.append(DistanceConstraint(0, i, 1, nb, brace, sigma_m))
        return tuple(rows)

    @classmethod
    def from_charuco(
        cls, charuco, sigma_m: float = DEFAULT_SIGMA_M, thickness_sigma_m: float = DEFAULT_THICKNESS_SIGMA_M
    ) -> "ConstraintSet":
        """Front-face truss (object 0); for thick boards also the back face's
        truss (object 1) + cross-face ties/braces at a tighter sigma (the
        thickness is a caliper measurement and the cross-face rows are the
        sole rigid link between front- and back-viewing camera groups)."""
        corners = charuco.chessboard_corners()
        spacing = charuco.square_size_m
        constraints = cls._truss_constraints(corners, spacing, sigma_m)
        if charuco.thickness_m > 0:
            constraints = (
                constraints
                + cls._truss_constraints(corners, spacing, sigma_m, object_id=1)
                + cls._cross_face_constraints(corners, spacing, charuco.thickness_m, thickness_sigma_m)
            )
        return cls(constraints, frozenset(), (), back_face_thickness_m=charuco.thickness_m)

    @classmethod
    def from_chessboard(cls, chessboard, sigma_m: float = DEFAULT_SIGMA_M) -> "ConstraintSet":
        if chessboard.square_size_m is None:
            raise ValueError(
                "from_chessboard requires square_size_m to be set; a unit-spacing "
                "constraint set would silently pin the wrong scale."
            )
        corners = chessboard.object_points()
        return cls(cls._truss_constraints(corners, chessboard.square_size_m, sigma_m), frozenset(), ())

    # ---- application --------------------------------------------------------
    def remap_image_points(self, image_points: ImagePoints) -> ImagePoints:
        """Apply zero-thickness mirror remaps: rewrite identity + obj_loc of
        remapped observations (no-op when point_remaps is empty)."""
        if not self.point_remaps:
            return image_points
        obj = image_points.object_id.copy()
        kp = image_points.keypoint_id.copy()
        ol = image_points.obj_loc.copy()
        for r in self.point_remaps:
            m = (image_points.object_id == r.object_id_from) & (image_points.keypoint_id == r.keypoint_id_from)
            obj[m] = r.object_id_to
            kp[m] = r.keypoint_id_to
            ol[m] = [r.obj_loc_x, r.obj_loc_y, r.obj_loc_z]
        return ImagePoints(
            image_points.sync_index, image_points.cam_id, obj, kp, image_points.img_xy, ol, image_points.frame_time
        )

    @property
    def has_constraints(self) -> bool:
        return bool(self.distances or self.centroid_distances)

    def compile_arrays(self, world_points: WorldPoints):
        """Instantiate firing constraints against a WorldPoints table.

        Returns (pa_idx (Q,4), pa_w, pb_idx, pb_w, target (Q,), sigma (Q,))
        or None. Mixed static/mobile constraints are skipped; static
        constraints fire once at STATIC_SYNC_INDEX; mobile ones fire at every
        sync where all endpoint rows exist, in the iteration order of the
        Python set of those syncs (the JAX package's order, kept so the rows
        match it one for one).
        """
        if not self.has_constraints or len(world_points) == 0:
            return None
        lookup: dict[tuple[int, int], dict[int, int]] = {}
        for row, (si, oid, kid) in enumerate(
            zip(world_points.sync_index, world_points.object_id, world_points.keypoint_id)
        ):
            lookup.setdefault((int(oid), int(kid)), {})[int(si)] = row

        pa_rows, pb_rows, pa_w, pb_w, dists, sigmas = [], [], [], [], [], []

        def firing(is_static: bool, lookups):
            if is_static:
                return [STATIC_SYNC_INDEX] if all(STATIC_SYNC_INDEX in lk for lk in lookups) else []
            shared = set.intersection(*(set(lk.keys()) for lk in lookups)) if lookups else set()
            return [s for s in shared if s != STATIC_SYNC_INDEX]

        for dc in self.distances:
            a_static = dc.object_id_a in self.static_object_ids
            b_static = dc.object_id_b in self.static_object_ids
            if a_static != b_static:
                continue
            la = lookup.get((dc.object_id_a, dc.keypoint_id_a), {})
            lb = lookup.get((dc.object_id_b, dc.keypoint_id_b), {})
            for si in firing(a_static, (la, lb)):
                pa_rows.append([la[si]] * 4)
                pb_rows.append([lb[si]] * 4)
                pa_w.append([1.0, 0.0, 0.0, 0.0])
                pb_w.append([1.0, 0.0, 0.0, 0.0])
                dists.append(dc.distance)
                sigmas.append(dc.sigma)

        for cc in self.centroid_distances:
            a_static = cc.object_id_a in self.static_object_ids
            b_static = cc.object_id_b in self.static_object_ids
            if a_static != b_static:
                continue
            ca = [lookup.get((cc.object_id_a, k), {}) for k in range(4)]
            cb = [lookup.get((cc.object_id_b, k), {}) for k in range(4)]
            for si in firing(a_static, (*ca, *cb)):
                pa_rows.append([ca[k][si] for k in range(4)])
                pb_rows.append([cb[k][si] for k in range(4)])
                pa_w.append([0.25] * 4)
                pb_w.append([0.25] * 4)
                dists.append(cc.distance)
                sigmas.append(cc.sigma)

        if not pa_rows:
            return None
        return (
            np.asarray(pa_rows, np.int32),
            np.asarray(pa_w),
            np.asarray(pb_rows, np.int32),
            np.asarray(pb_w),
            np.asarray(dists),
            np.asarray(sigmas),
        )

    # ---- persistence --------------------------------------------------------
    def to_toml(self, path: Path | str) -> None:
        data: dict = {
            "static_object_ids": sorted(self.static_object_ids),
            "distances": [
                {
                    "object_id_a": d.object_id_a,
                    "keypoint_id_a": d.keypoint_id_a,
                    "object_id_b": d.object_id_b,
                    "keypoint_id_b": d.keypoint_id_b,
                    "distance": d.distance,
                    "sigma": d.sigma,
                }
                for d in self.distances
            ],
        }
        if self.centroid_distances:
            data["centroid_distances"] = [
                {"object_id_a": c.object_id_a, "object_id_b": c.object_id_b, "distance": c.distance, "sigma": c.sigma}
                for c in self.centroid_distances
            ]
        if self.point_remaps:
            data["point_remaps"] = [
                {
                    "object_id_from": r.object_id_from,
                    "keypoint_id_from": r.keypoint_id_from,
                    "object_id_to": r.object_id_to,
                    "keypoint_id_to": r.keypoint_id_to,
                    "obj_loc_x": r.obj_loc_x,
                    "obj_loc_y": r.obj_loc_y,
                    "obj_loc_z": r.obj_loc_z,
                }
                for r in self.point_remaps
            ]
        if self.back_face_thickness_m is not None:
            data["back_face_thickness_m"] = self.back_face_thickness_m
        persistence.safe_write_toml(data, path)

    @classmethod
    def from_toml(cls, path: Path | str) -> "ConstraintSet":
        path = Path(path)
        if not path.exists():
            raise PersistenceError(f"ConstraintSet file not found: {path}")
        try:
            data = persistence.load_toml(path)
            distances = tuple(
                DistanceConstraint(
                    d["object_id_a"], d["keypoint_id_a"], d["object_id_b"], d["keypoint_id_b"],
                    d["distance"], d["sigma"],
                )
                for d in data.get("distances", [])
            )
            centroids = tuple(
                CentroidDistanceConstraint(c["object_id_a"], c["object_id_b"], c["distance"], c["sigma"])
                for c in data.get("centroid_distances", [])
            )
            remaps = tuple(
                PointRemap(
                    r["object_id_from"], r["keypoint_id_from"], r["object_id_to"], r["keypoint_id_to"],
                    r["obj_loc_x"], r["obj_loc_y"], r["obj_loc_z"],
                )
                for r in data.get("point_remaps", [])
            )
            return cls(
                distances,
                frozenset(data.get("static_object_ids", [])),
                centroids,
                remaps,
                data.get("back_face_thickness_m"),
            )
        except PersistenceError:
            raise
        except Exception as e:
            raise PersistenceError(f"Failed to load ConstraintSet from {path}: {e}") from e


# ---------------------------------------------------------------------------
# Rigidity report
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RigidityReport:
    """Constraint violations measured against current world points — pure
    measurement, no optimization."""

    expected: np.ndarray  # (V,)
    actual: np.ndarray  # (V,)
    object_pairs: np.ndarray  # (V, 2) [object_id_a, object_id_b]

    @property
    def n_violations(self) -> int:
        return len(self.expected)

    @property
    def rmse_mm(self) -> float:
        if not len(self.expected):
            return 0.0
        return float(np.sqrt(np.mean((self.actual - self.expected) ** 2)) * 1000.0)

    @property
    def relative_rmse_pct(self) -> float:
        if not len(self.expected):
            return 0.0
        rel = (self.actual - self.expected) / self.expected
        return float(np.sqrt(np.mean(rel**2)) * 100.0)

    @property
    def max_violation_mm(self) -> float:
        if not len(self.expected):
            return 0.0
        return float(np.max(np.abs(self.actual - self.expected)) * 1000.0)

    @property
    def per_object_rmse_mm(self) -> dict[int, float]:
        out: dict[int, list[float]] = {}
        err = self.actual - self.expected
        for e, (a, b) in zip(err, self.object_pairs):
            for oid in {int(a), int(b)}:
                out.setdefault(oid, []).append(float(e))
        return {oid: float(np.sqrt(np.mean(np.square(v))) * 1000.0) for oid, v in out.items()}


def rigidity_report(constraint_set: ConstraintSet | None, world_points: WorldPoints) -> RigidityReport:
    """Evaluate every firing constraint's actual vs expected distance."""
    empty = RigidityReport(np.zeros(0), np.zeros(0), np.zeros((0, 2), np.int64))
    if constraint_set is None or not constraint_set.has_constraints or len(world_points) == 0:
        return empty
    arrays = constraint_set.compile_arrays(world_points)
    if arrays is None:
        return empty
    pa_idx, pa_w, pb_idx, pb_w, dists, _sigmas = arrays
    X = world_points.xyz
    pa = np.einsum("qk,qkj->qj", pa_w, X[pa_idx])
    pb = np.einsum("qk,qkj->qj", pb_w, X[pb_idx])
    actual = np.linalg.norm(pa - pb, axis=1)
    obj = world_points.object_id
    pairs = np.stack([obj[pa_idx[:, 0]], obj[pb_idx[:, 0]]], axis=1)
    return RigidityReport(np.asarray(dists), actual, pairs)
