"""ArUco dictionary bit patterns + rotation-invariant matching (host code,
a copy of caliscope_tpu/detect/dictionaries.py; the .npz beside it is a
byte-identical copy of that package's).

The bit patterns are the public ArUco dictionary constants (Garrido-Jurado et
al.), stored as packed data (data/aruco_dictionaries.npz) so decoding needs no
OpenCV at runtime. Matching: Hamming distance under all four rotations via one
±1 matmul, accept when within the dictionary's
max-correction-bits budget.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA_PATH = Path(__file__).parent / "data" / "aruco_dictionaries.npz"


@dataclass(frozen=True)
class ArucoDictionary:
    name: str
    bits: np.ndarray  # (n_ids, n, n) uint8
    max_correction_bits: int

    @property
    def n_ids(self) -> int:
        return self.bits.shape[0]

    @property
    def marker_size(self) -> int:
        return self.bits.shape[1]

    def rotations_pm1(self) -> np.ndarray:
        """(n_ids, 4, n*n) in ±1 encoding for the matmul matcher; rotation r
        is the dictionary marker rotated r*90deg counter-clockwise."""
        n = self.marker_size
        out = np.zeros((self.n_ids, 4, n * n), np.float32)
        for r in range(4):
            rot = np.rot90(self.bits, k=r, axes=(1, 2))
            out[:, r] = (rot.reshape(self.n_ids, -1) * 2.0 - 1.0)
        return out


@lru_cache(maxsize=None)
def get_dictionary(name: str) -> ArucoDictionary:
    data = np.load(_DATA_PATH)
    if name not in data:
        available = sorted(k for k in data.files if not k.endswith("__maxcorr"))
        raise KeyError(f"Unknown ArUco dictionary {name}; available: {available}")
    return ArucoDictionary(
        name=name,
        bits=np.asarray(data[name]),
        max_correction_bits=int(data[name + "__maxcorr"]),
    )


def match_bits(sampled_bits: np.ndarray, dictionary: ArucoDictionary):
    """Match sampled n x n bit grids to the dictionary under 4 rotations.

    Args:
        sampled_bits: (K, n, n) float in [0, 1] (soft bits fine).

    Returns (ids (K,), rotations (K,), hamming (K,)) — id -1 when the best
    match exceeds max_correction_bits.
    """
    K = sampled_bits.shape[0]
    n = dictionary.marker_size
    if K == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    obs = (np.asarray(sampled_bits).reshape(K, -1) > 0.5).astype(np.float32) * 2.0 - 1.0
    ref = dictionary.rotations_pm1().reshape(-1, n * n)  # (n_ids*4, n*n)
    sim = obs @ ref.T  # (K, n_ids*4)
    hamming = (n * n - sim) / 2.0
    flat = np.argmin(hamming, axis=1)
    best_h = hamming[np.arange(K), flat]
    ids = flat // 4
    rots = flat % 4
    ok = best_h <= dictionary.max_correction_bits
    return np.where(ok, ids, -1).astype(np.int64), rots.astype(np.int64), best_h.astype(np.int64)
