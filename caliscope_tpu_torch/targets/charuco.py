"""ChArUco board definition (geometry + identity scheme); host code, a copy
of caliscope_tpu/targets/charuco.py.

Parity: reference src/caliscope/core/charuco.py (Charuco:84, from_squares:136,
fit_dictionary_pool:50, thickness two-sided semantics :102-115, corner
connectivity :288, object corners :326). No OpenCV handle: the board is plain
geometry. Inner-corner layout matches cv2.aruco.CharucoBoard's
getChessboardCorners exactly — (columns-1) x (rows-1) corners, row-major with
x fastest, corner k at ((k % (cols-1) + 1) * s, (k // (cols-1) + 1) * s, 0) —
so keypoint ids interoperate with recordings extracted by the reference.

Identity scheme (two-sided boards): front face = object_id 0; when
thickness_m > 0 the mirrored back face is object_id 1 with the same keypoint
grid and obj_loc z = +thickness (reference charuco_tracker.py:77-85).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

# Capacity of the standard ArUco dictionary families (marker count), keyed by
# the OpenCV predefined-dictionary name. Needed for dictionary-pool fitting
# without importing OpenCV.
ARUCO_DICTIONARY_CAPACITY: dict[str, int] = {
    "DICT_4X4_50": 50,
    "DICT_4X4_100": 100,
    "DICT_4X4_250": 250,
    "DICT_4X4_1000": 1000,
    "DICT_5X5_50": 50,
    "DICT_5X5_100": 100,
    "DICT_5X5_250": 250,
    "DICT_5X5_1000": 1000,
    "DICT_6X6_50": 50,
    "DICT_6X6_100": 100,
    "DICT_6X6_250": 250,
    "DICT_6X6_1000": 1000,
    "DICT_7X7_50": 50,
    "DICT_7X7_100": 100,
    "DICT_7X7_1000": 1000,
    "DICT_ARUCO_ORIGINAL": 1024,
    "DICT_APRILTAG_16h5": 30,
    "DICT_APRILTAG_25h9": 35,
    "DICT_APRILTAG_36h10": 2320,
    "DICT_APRILTAG_36h11": 587,
}

_LADDER = [50, 100, 250, 1000]


class DictionaryCapacityError(ValueError):
    """The board needs more markers than any dictionary in the family holds."""


def fit_dictionary_pool(dictionary: str, marker_count: int) -> str:
    """Pick the smallest dictionary in the same family with enough capacity
    (reference charuco.py:50-81). Smaller pools -> greater inter-marker
    Hamming distance -> more reliable decode."""
    parts = dictionary.split("_")
    if len(parts) != 3 or not parts[2].isdigit() or parts[0] != "DICT":
        capacity = ARUCO_DICTIONARY_CAPACITY.get(dictionary)
        if capacity is None or capacity < marker_count:
            raise DictionaryCapacityError(
                f"Dictionary {dictionary} holds {capacity} markers but the board needs {marker_count}."
            )
        return dictionary
    family = f"{parts[0]}_{parts[1]}"
    for size in _LADDER:
        candidate = f"{family}_{size}"
        if candidate in ARUCO_DICTIONARY_CAPACITY and ARUCO_DICTIONARY_CAPACITY[candidate] >= marker_count:
            return candidate
    raise DictionaryCapacityError(
        f"No {family} dictionary holds {marker_count} markers (largest is "
        f"{max(s for s in _LADDER if f'{family}_{s}' in ARUCO_DICTIONARY_CAPACITY)})."
    )


@dataclass(frozen=True)
class Charuco:
    """rows x columns SQUARES; markers sit on the white squares.

    square_size_m is the measured printed square edge — the board's metric
    scale anchor. aruco_scale is marker edge / square edge.
    """

    rows: int
    columns: int
    square_size_m: float
    aruco_scale: float = 0.75
    dictionary: str = "DICT_4X4_50"
    legacy_pattern: bool = False  # marker-on-black-square variant
    thickness_m: float = 0.0  # two-sided board substrate thickness
    inverted: bool = False  # white-on-black print (reference charuco.py:100)

    def __post_init__(self):
        if self.rows < 3 or self.columns < 3:
            raise ValueError("ChArUco board needs at least 3x3 squares")
        if self.square_size_m <= 0:
            raise ValueError(f"square_size_m must be positive, got {self.square_size_m}")
        if not (0 < self.aruco_scale < 1):
            raise ValueError(f"aruco_scale must be in (0, 1), got {self.aruco_scale}")
        if self.thickness_m < 0:
            raise ValueError(f"thickness_m must be >= 0, got {self.thickness_m}")
        if self.dictionary not in ARUCO_DICTIONARY_CAPACITY:
            raise ValueError(f"Unknown ArUco dictionary {self.dictionary}")
        if ARUCO_DICTIONARY_CAPACITY[self.dictionary] < self.n_markers:
            raise ValueError(
                f"Dictionary {self.dictionary} holds {ARUCO_DICTIONARY_CAPACITY[self.dictionary]} markers "
                f"but the board needs {self.n_markers}; use fit_dictionary_pool()."
            )

    @classmethod
    def from_squares(
        cls,
        columns: int,
        rows: int,
        square_size_cm: float,
        aruco_scale: float = 0.75,
        dictionary: str = "DICT_4X4_50",
        thickness_cm: float = 0.0,
        auto_fit_dictionary: bool = True,
    ) -> "Charuco":
        """cm-based factory matching the reference's GUI units
        (reference charuco.py:136-176)."""
        n_markers = (rows * columns) // 2
        if auto_fit_dictionary:
            dictionary = fit_dictionary_pool(dictionary, n_markers)
        return cls(
            rows=rows,
            columns=columns,
            square_size_m=square_size_cm / 100.0,
            aruco_scale=aruco_scale,
            dictionary=dictionary,
            thickness_m=thickness_cm / 100.0,
        )

    # ---- derived geometry ---------------------------------------------------
    @property
    def inner_rows(self) -> int:
        return self.rows - 1

    @property
    def inner_columns(self) -> int:
        return self.columns - 1

    @property
    def n_corners(self) -> int:
        return self.inner_rows * self.inner_columns

    @property
    def n_markers(self) -> int:
        """One marker per white square (OpenCV convention: ceil for the
        non-legacy checker phase)."""
        return (self.rows * self.columns) // 2

    @property
    def board_width_m(self) -> float:
        return self.columns * self.square_size_m

    @property
    def board_height_m(self) -> float:
        return self.rows * self.square_size_m

    @property
    def two_sided(self) -> bool:
        return self.thickness_m > 0

    def chessboard_corners(self) -> np.ndarray:
        """(N, 3) inner-corner coordinates, cv2.aruco.CharucoBoard layout."""
        s = self.square_size_m
        cols, rows = self.inner_columns, self.inner_rows
        xs, ys = np.meshgrid(np.arange(1, cols + 1), np.arange(1, rows + 1))
        pts = np.zeros((rows * cols, 3))
        pts[:, 0] = xs.ravel() * s
        pts[:, 1] = ys.ravel() * s
        return pts

    def object_corners(self, object_id: int = 0) -> np.ndarray:
        """Corner coordinates for the given face: front (0) at z=0, back (1)
        at z=+thickness DIRECTLY BEHIND the same-index front corner.

        The back face carries the mirror print, so a behind-the-board camera
        sees the front pattern mirrored; detecting on the flipped image and
        unflipping x recovers corner k at the physical point straight through
        the substrate from front corner k — same (x, y), z = +thickness
        (reference charuco_tracker.py:123-140: "ids are always front-face
        corner indices... back-face detections keep the same keypoint ids").
        """
        pts = self.chessboard_corners()
        if object_id == 0:
            return pts
        if object_id == 1 and self.two_sided:
            back = pts.copy()
            back[:, 2] = self.thickness_m
            return back
        raise ValueError(f"object_id {object_id} invalid for this board (two_sided={self.two_sided})")

    def expected_object_ids(self) -> frozenset[int]:
        """The closed identity universe the extraction must match
        (reference constraints.py back_face_thickness_m rationale)."""
        return frozenset({0, 1}) if self.two_sided else frozenset({0})

    def marker_square_positions(self) -> list[tuple[int, int]]:
        """(col, row) of the squares carrying markers, in marker-id order.

        OpenCV convention: markers occupy squares where (row + col) is odd
        for the current pattern (first square black), iterated row-major.
        legacy_pattern flips the phase.
        """
        phase = 0 if self.legacy_pattern else 1
        out = []
        for r in range(self.rows):
            for c in range(self.columns):
                if (r + c) % 2 == phase:
                    out.append((c, r))
        return out

    def connectivity(self) -> list[tuple[int, int]]:
        """Grid-neighbor corner edges (for wireframe overlays,
        reference charuco.py:288)."""
        cols = self.inner_columns
        edges = []
        for k in range(self.n_corners):
            c, r = k % cols, k // cols
            if c + 1 < cols:
                edges.append((k, k + 1))
            if r + 1 < self.inner_rows:
                edges.append((k, k + cols))
        return edges

    # ---- rendering ----------------------------------------------------------
    def save_image(self, path, px_per_square: int = 300, mirror: bool = False) -> None:
        """Write the printable board as a grey 8-bit PNG (reference
        charuco.py:275 save_image / save_mirror_image — high-resolution print
        export), encoded with the standard library (persistence.write_png_gray)."""
        from caliscope_tpu_torch import persistence

        img = self.board_image(px_per_square=px_per_square)
        if mirror:
            img = img[:, ::-1]
        persistence.write_png_gray(np.ascontiguousarray(img), path)

    def save_mirror_image(self, path, px_per_square: int = 300) -> None:
        self.save_image(path, px_per_square=px_per_square, mirror=True)

    def board_image(self, px_per_square: int = 120, margin_squares: float = 0.5) -> "np.ndarray":
        """Render the printable board as a uint8 grayscale image (pure numpy,
        using the embedded dictionary bit patterns — reference charuco.py:239
        delegates to cv2; this renderer needs no OpenCV)."""
        from caliscope_tpu_torch.detect.dictionaries import get_dictionary

        d = get_dictionary(self.dictionary)
        m = int(round(margin_squares * px_per_square))
        H = self.rows * px_per_square + 2 * m
        W = self.columns * px_per_square + 2 * m
        img = np.full((H, W), 255, np.uint8)
        phase = 0 if self.legacy_pattern else 1
        # chessboard squares
        for r in range(self.rows):
            for c in range(self.columns):
                if (r + c) % 2 != phase:
                    y0, x0 = m + r * px_per_square, m + c * px_per_square
                    img[y0 : y0 + px_per_square, x0 : x0 + px_per_square] = 0
        # markers on white squares
        a_px = int(round(self.aruco_scale * px_per_square))
        n = d.marker_size
        cell = max(a_px // (n + 2), 1)
        a_used = cell * (n + 2)
        off = (px_per_square - a_used) // 2
        for mid, (c, r) in enumerate(self.marker_square_positions()):
            bits = d.bits[mid]
            y0 = m + r * px_per_square + off
            x0 = m + c * px_per_square + off
            patch = np.zeros((n + 2, n + 2), np.uint8)
            patch[1:-1, 1:-1] = bits * 255
            img[y0 : y0 + a_used, x0 : x0 + a_used] = np.kron(patch, np.ones((cell, cell), np.uint8))
        return img

    def mirror_image(self, px_per_square: int = 120) -> "np.ndarray":
        """The back-face print of a two-sided board (horizontally mirrored,
        reference charuco.py:281)."""
        return self.board_image(px_per_square)[:, ::-1].copy()

    # ---- persistence --------------------------------------------------------
    def to_toml(self, path: Path | str) -> None:
        from caliscope_tpu_torch import persistence

        persistence.safe_write_toml(
            {
                "type": "charuco",
                "rows": self.rows,
                "columns": self.columns,
                "square_size_m": self.square_size_m,
                "aruco_scale": self.aruco_scale,
                "dictionary": self.dictionary,
                "legacy_pattern": self.legacy_pattern,
                "thickness_m": self.thickness_m,
                "inverted": self.inverted,
            },
            path,
        )

    @classmethod
    def from_toml(cls, path: Path | str) -> "Charuco":
        """Load our schema OR the reference's charuco.toml schema (columns,
        rows, square_size_override_cm, thickness_cm, inverted, ...)."""
        from caliscope_tpu_torch import persistence

        d = persistence.load_toml(path)
        if "square_size_m" in d:
            square_m = float(d["square_size_m"])
        elif d.get("square_size_override_cm"):
            square_m = float(d["square_size_override_cm"]) / 100.0
        else:
            # reference fallback: maximize square size within board dims
            unit_cm = 2.54 if d.get("units") == "inch" else 1.0
            bh = float(d["board_height"]) * unit_cm
            bw = float(d["board_width"]) * unit_cm
            square_m = min(bh / int(d["rows"]), bw / int(d["columns"])) / 100.0
        thickness_m = float(d.get("thickness_m", float(d.get("thickness_cm", 0.0)) / 100.0))
        return cls(
            rows=int(d["rows"]),
            columns=int(d["columns"]),
            square_size_m=square_m,
            aruco_scale=float(d.get("aruco_scale", 0.75)),
            dictionary=d.get("dictionary", "DICT_4X4_50"),
            legacy_pattern=bool(d.get("legacy_pattern", False)),
            thickness_m=thickness_m,
            inverted=bool(d.get("inverted", False)),
        )
