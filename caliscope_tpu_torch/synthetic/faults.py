"""Data-level fault injection for robustness tests.

Port of caliscope_tpu/synthetic/faults.py: outlier injection, visibility
dropout, occlusion windows and killed pair linkages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from caliscope_tpu_torch.observations import ImagePoints


def inject_outliers(
    image_points: ImagePoints,
    fraction: float,
    magnitude_px: float,
    rng: np.random.Generator,
) -> tuple[ImagePoints, np.ndarray]:
    """Corrupt a random fraction of observations by a large pixel offset in a
    random direction. Returns (corrupted points, bool mask of corrupted rows).
    """
    n = len(image_points)
    n_out = int(round(fraction * n))
    idx = rng.choice(n, size=n_out, replace=False)
    angles = rng.uniform(0, 2 * np.pi, size=n_out)
    offsets = magnitude_px * np.stack([np.cos(angles), np.sin(angles)], axis=1)
    xy = image_points.img_xy.copy()
    xy[idx] += offsets
    mask = np.zeros(n, bool)
    mask[idx] = True
    return (
        ImagePoints(
            image_points.sync_index,
            image_points.cam_id,
            image_points.object_id,
            image_points.keypoint_id,
            xy,
            image_points.obj_loc,
            image_points.frame_time,
        ),
        mask,
    )


@dataclass
class VisibilityFilter:
    """Composable visibility degradation applied to perfect observations.

    - dropout: each observation independently dropped with this probability.
    - occlusions: list of (cam_id, sync_start, sync_end) windows where a
      camera sees nothing (someone walked in front of it).
    - killed_pairs: list of (cam_a, cam_b): remove co-observations so the pair
      shares no points — forces transitive (bridged) pose recovery.
    """

    dropout: float = 0.0
    occlusions: list[tuple[int, int, int]] = field(default_factory=list)
    killed_pairs: list[tuple[int, int]] = field(default_factory=list)
    seed: int = 0

    def apply(self, ip: ImagePoints) -> ImagePoints:
        rng = np.random.default_rng(self.seed)
        keep = np.ones(len(ip), bool)
        if self.dropout > 0:
            keep &= rng.uniform(size=len(ip)) >= self.dropout
        for cam_id, s0, s1 in self.occlusions:
            keep &= ~((ip.cam_id == cam_id) & (ip.sync_index >= s0) & (ip.sync_index <= s1))
        for cam_a, cam_b in self.killed_pairs:
            # Remove cam_b's member of every co-observed point of the pair.
            pt_idx, _ = ip.point_index()
            in_a = np.zeros(pt_idx.max() + 1, bool)
            in_a[pt_idx[ip.cam_id == cam_a]] = True
            keep &= ~((ip.cam_id == cam_b) & in_a[pt_idx])
        return ip.select(keep)
