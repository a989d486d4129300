"""ArUco marker-set domain: markers, measured links, mirror pairs.

Host-only copy of caliscope_tpu/targets/aruco.py. Reference
src/caliscope/core/aruco_marker.py (ArucoMarker:17, DistanceLink:38,
MirrorPair:78 with winding-reversal corner_mapping:110, ArucoMarkerSet:120 with
validation + TOML round trip :202-259). Identity scheme: object_id = marker_id,
keypoint_id = corner 0..3 (TL, TR, BR, BL).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from caliscope_tpu_torch.exceptions import PersistenceError
from caliscope_tpu_torch.targets.charuco import ARUCO_DICTIONARY_CAPACITY


@dataclass(frozen=True)
class ArucoMarker:
    marker_id: int
    size_m: float
    static: bool = False

    def __post_init__(self):
        if self.size_m <= 0:
            raise ValueError(f"marker size_m wants a positive length, not {self.size_m}")

    @property
    def corners(self) -> np.ndarray:
        """(4, 3) corner positions in marker-local frame: origin at center,
        X right, Y up, Z=0, ordered TL, TR, BR, BL."""
        s = self.size_m / 2
        return np.array([[-s, +s, 0.0], [+s, +s, 0.0], [+s, -s, 0.0], [-s, -s, 0.0]])


@dataclass(frozen=True)
class DistanceLink:
    """One measured distance between two markers.

    Corner link: corner_a/corner_b both set (0..3). Center link: both None —
    distance between corner centroids. sigma_m None -> compile-time default
    (2 mm corner, 5 mm center).
    """

    marker_a: int
    marker_b: int
    distance_m: float
    corner_a: int | None = None
    corner_b: int | None = None
    sigma_m: float | None = None

    def __post_init__(self):
        if self.marker_a == self.marker_b:
            raise ValueError(f"a DistanceLink cannot join marker {self.marker_a} to itself")
        if (self.corner_a is None) != (self.corner_b is None):
            raise ValueError("DistanceLink needs corner_a and corner_b either both given or both omitted")
        for c in (self.corner_a, self.corner_b):
            if c is not None and not (0 <= c <= 3):
                raise ValueError(f"corner index must be in 0..3, got {c}")
        if self.distance_m <= 0:
            raise ValueError(f"link distance_m wants a positive length, not {self.distance_m}")
        if self.sigma_m is not None and self.sigma_m <= 0:
            raise ValueError(f"when given, sigma_m needs to be > 0 (got {self.sigma_m})")

    @property
    def is_center(self) -> bool:
        return self.corner_a is None


@dataclass(frozen=True)
class MirrorPair:
    """Two markers printed on opposite faces of a rigid board.

    The anchor corner pair determines the full mapping by winding reversal
    (looking through the board flips the corner winding). thickness_m == 0:
    corresponding corners are the same 3D point (marker B remapped to A's
    identity); thickness_m > 0: per-corner distance constraints at the
    thickness.
    """

    marker_a: int
    marker_b: int
    anchor_corner_a: int
    anchor_corner_b: int
    thickness_m: float
    sigma_m: float | None = None

    def __post_init__(self):
        if self.marker_a == self.marker_b:
            raise ValueError(f"a MirrorPair cannot pair marker {self.marker_a} with itself")
        for c in (self.anchor_corner_a, self.anchor_corner_b):
            if not (0 <= c <= 3):
                raise ValueError(f"anchor corner must be in 0..3, got {c}")
        if self.thickness_m < 0:
            raise ValueError(f"thickness_m cannot be negative (got {self.thickness_m})")
        if self.sigma_m is not None and self.sigma_m <= 0:
            raise ValueError(f"sigma_m needs to be > 0 (got {self.sigma_m})")

    @property
    def corner_mapping(self) -> tuple[tuple[int, int], ...]:
        """Four (corner_a, corner_b) pairs: advancing around face A walks
        backwards around face B (winding reversal)."""
        return tuple(((self.anchor_corner_a + k) % 4, (self.anchor_corner_b - k) % 4) for k in range(4))

    @property
    def is_zero_thickness(self) -> bool:
        return self.thickness_m == 0.0


@dataclass(frozen=True)
class ArucoMarkerSet:
    dictionary: str
    markers: dict[int, ArucoMarker]
    links: tuple[DistanceLink, ...] = ()
    mirror_pairs: tuple[MirrorPair, ...] = ()

    def __post_init__(self):
        if not self.markers:
            raise ValueError("an ArucoMarkerSet with zero markers is not usable")
        capacity = ARUCO_DICTIONARY_CAPACITY.get(self.dictionary)
        if capacity is None:
            raise ValueError(f"Unknown ArUco dictionary {self.dictionary}")
        for mid, marker in self.markers.items():
            if marker.marker_id != mid:
                raise ValueError(f"dict key {mid} disagrees with the marker's own id {marker.marker_id}")
            if mid < 0 or mid >= capacity:
                raise ValueError(f"marker id {mid} is outside the {capacity}-entry dictionary")

        seen_pairs: set[frozenset] = set()
        for link in self.links:
            for m in (link.marker_a, link.marker_b):
                if m not in self.markers:
                    raise ValueError(f"DistanceLink references unknown marker {m}")
            if self.markers[link.marker_a].static != self.markers[link.marker_b].static:
                raise ValueError(
                    f"DistanceLink between {link.marker_a} and {link.marker_b} mixes static and mobile "
                    f"markers; the solver skips mixed pairs so this link would do nothing"
                )
            key = frozenset(((link.marker_a, link.corner_a), (link.marker_b, link.corner_b)))
            if key in seen_pairs:
                raise ValueError(f"Duplicate DistanceLink between {link.marker_a} and {link.marker_b}")
            seen_pairs.add(key)

        seen_marker_ids: set[int] = set()
        pair_marker_sets: set[frozenset[int]] = set()
        zero_thickness_b: set[int] = set()
        for pair in self.mirror_pairs:
            for m in (pair.marker_a, pair.marker_b):
                if m not in self.markers:
                    raise ValueError(f"MirrorPair references unknown marker {m}")
                if m in seen_marker_ids:
                    raise ValueError(f"Marker {m} appears in multiple mirror pairs")
                seen_marker_ids.add(m)
            if self.markers[pair.marker_a].size_m != self.markers[pair.marker_b].size_m:
                raise ValueError(f"MirrorPair markers {pair.marker_a} and {pair.marker_b} must share size_m")
            if self.markers[pair.marker_a].static != self.markers[pair.marker_b].static:
                raise ValueError("both members of a MirrorPair must share the static flag")
            pair_marker_sets.add(frozenset((pair.marker_a, pair.marker_b)))
            if pair.is_zero_thickness:
                zero_thickness_b.add(pair.marker_b)

        for link in self.links:
            if frozenset((link.marker_a, link.marker_b)) in pair_marker_sets:
                raise ValueError(
                    f"markers {link.marker_a} and {link.marker_b} are joined by both a MirrorPair and a DistanceLink — drop one"
                )
            for m in (link.marker_a, link.marker_b):
                if m in zero_thickness_b:
                    raise ValueError(
                        f"DistanceLink references marker {m} which is remapped away by a zero-thickness MirrorPair"
                    )

    # ---- persistence --------------------------------------------------------
    def to_toml(self, path: Path | str) -> None:
        from caliscope_tpu_torch import persistence

        markers_data = []
        for m in sorted(self.markers.values(), key=lambda m: m.marker_id):
            entry: dict = {"id": m.marker_id, "size_m": m.size_m}
            if m.static:
                entry["static"] = True
            markers_data.append(entry)
        data: dict = {"dictionary": self.dictionary, "markers": markers_data}
        if self.links:
            links_data = []
            for link in self.links:
                e: dict = {"marker_a": link.marker_a, "marker_b": link.marker_b, "distance_m": link.distance_m}
                if not link.is_center:
                    e["corner_a"] = link.corner_a
                    e["corner_b"] = link.corner_b
                if link.sigma_m is not None:
                    e["sigma_m"] = link.sigma_m
                links_data.append(e)
            data["links"] = links_data
        if self.mirror_pairs:
            data["mirror_pairs"] = [
                {
                    "marker_a": p.marker_a,
                    "marker_b": p.marker_b,
                    "anchor_corner_a": p.anchor_corner_a,
                    "anchor_corner_b": p.anchor_corner_b,
                    "thickness_m": p.thickness_m,
                    **({"sigma_m": p.sigma_m} if p.sigma_m is not None else {}),
                }
                for p in self.mirror_pairs
            ]
        persistence.safe_write_toml(data, path)

    @classmethod
    def from_toml(cls, path: Path | str) -> "ArucoMarkerSet":
        from caliscope_tpu_torch import persistence

        path = Path(path)
        if not path.exists():
            raise PersistenceError(f"no ArucoMarkerSet file at {path}")
        try:
            data = persistence.load_toml(path)
            markers = {
                e["id"]: ArucoMarker(marker_id=e["id"], size_m=e["size_m"], static=e.get("static", False))
                for e in data.get("markers", [])
            }
            links = tuple(
                DistanceLink(
                    marker_a=e["marker_a"],
                    marker_b=e["marker_b"],
                    distance_m=e["distance_m"],
                    corner_a=e.get("corner_a"),
                    corner_b=e.get("corner_b"),
                    sigma_m=e.get("sigma_m"),
                )
                for e in data.get("links", [])
            )
            mirror_pairs = tuple(
                MirrorPair(
                    marker_a=e["marker_a"],
                    marker_b=e["marker_b"],
                    anchor_corner_a=e["anchor_corner_a"],
                    anchor_corner_b=e["anchor_corner_b"],
                    thickness_m=e["thickness_m"],
                    sigma_m=e.get("sigma_m"),
                )
                for e in data.get("mirror_pairs", [])
            )
            return cls(dictionary=data["dictionary"], markers=markers, links=links, mirror_pairs=mirror_pairs)
        except PersistenceError:
            raise
        except Exception as e:
            raise PersistenceError(f"could not parse ArucoMarkerSet at {path}: {e}") from e
