"""Plain chessboard calibration target.

Host-only copy of caliscope_tpu/targets/chessboard.py. Reference
src/caliscope/core/chessboard.py (Chessboard:8). Identity scheme: object_id=0,
keypoint_id = internal-corner index (row-major, x fastest). Conventions match
the reference exactly so its chessboard.toml files and xy CSVs drop in
unchanged: rows/columns count INTERNAL CORNERS (reference chessboard.py:18-19 —
"e.g., 6 for 7 rows of squares"), the origin sits at the top-left internal
corner (corner k at (k % columns * s, k // columns * s, 0), reference :35-49),
and TOML carries square_size_cm in centimeters (reference :82-85).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class Chessboard:
    """rows x columns INTERNAL CORNERS (a board of (rows+1) x (columns+1) squares)."""

    rows: int
    columns: int
    square_size_m: float | None = None

    def __post_init__(self):
        if self.rows < 2 or self.columns < 2:
            raise ValueError("Chessboard needs at least a 2x2 internal corner grid")
        if self.square_size_m is not None and self.square_size_m <= 0:
            raise ValueError(f"square_size_m must be positive, got {self.square_size_m}")

    @property
    def inner_rows(self) -> int:
        return self.rows

    @property
    def inner_columns(self) -> int:
        return self.columns

    @property
    def n_corners(self) -> int:
        return self.rows * self.columns

    def object_points(self) -> np.ndarray:
        """(N, 3) internal-corner coordinates, origin at the top-left corner;
        unit spacing when square size is unknown (intrinsics-only use),
        meters when set (reference chessboard.py:31-49)."""
        s = self.square_size_m if self.square_size_m is not None else 1.0
        xs, ys = np.meshgrid(np.arange(self.columns), np.arange(self.rows))
        pts = np.zeros((self.n_corners, 3))
        pts[:, 0] = xs.ravel() * s
        pts[:, 1] = ys.ravel() * s
        return pts

    def connectivity(self) -> list[tuple[int, int]]:
        """Grid-neighbor edges for wireframe overlays (reference :90-103)."""
        cols = self.columns
        edges = []
        for k in range(self.n_corners):
            c, r = k % cols, k // cols
            if c + 1 < cols:
                edges.append((k, k + 1))
            if r + 1 < self.rows:
                edges.append((k, k + cols))
        return edges

    def to_toml(self, path: Path | str) -> None:
        from caliscope_tpu_torch import persistence

        data: dict = {"rows": self.rows, "columns": self.columns}
        if self.square_size_m is not None:
            data["square_size_cm"] = self.square_size_m * 100.0
        persistence.safe_write_toml(data, path)

    @classmethod
    def from_toml(cls, path: Path | str) -> "Chessboard":
        from caliscope_tpu_torch import persistence

        d = persistence.load_toml(path)
        if "square_size_cm" in d:
            size_m = float(d["square_size_cm"]) / 100.0
        elif "square_size_m" in d:
            size_m = float(d["square_size_m"])
        else:
            size_m = None
        return cls(rows=int(d["rows"]), columns=int(d["columns"]), square_size_m=size_m)
