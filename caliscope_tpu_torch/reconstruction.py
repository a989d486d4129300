"""Reconstruction stage 2: gap-fill -> triangulate -> export.

Port of caliscope_tpu/reconstruction.py. Writes xyz_{tracker}.csv,
xyz_{tracker}_labelled.csv and xyz_{tracker}.trc; writes nothing when no
points triangulate (an empty xyz file would flip the workflow status to a
false COMPLETE). The triangulation runs on `device` (CUDA unless named);
the files are written on the host without pandas.
"""

from __future__ import annotations

import logging
from pathlib import Path

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.export import xyz_to_trc, xyz_to_wide_labelled
from caliscope_tpu_torch.observations import ImagePoints

logger = logging.getLogger(__name__)


def reconstruct_xyz(
    image_points: ImagePoints,
    camera_array: CameraArray,
    tracker,
    output_dir: Path | str,
    xy_gap_fill: int = 3,
    device=None,
) -> None:
    """Triangulate image points and write xyz csv / labelled csv / trc."""
    output_dir = Path(output_dir)
    if len(image_points) == 0:
        logger.warning("No 2D points to triangulate; skipping reconstruction output.")
        return

    filled = image_points.fill_gaps(max_gap=xy_gap_fill)
    xyz = filled.triangulate(camera_array, device=device)
    if len(xyz) == 0:
        logger.warning("No points were triangulated; skipping reconstruction output.")
        return

    output_dir.mkdir(parents=True, exist_ok=True)
    xyz.to_csv(output_dir / f"xyz_{tracker.name}.csv")
    xyz_to_wide_labelled(xyz, tracker).to_csv(output_dir / f"xyz_{tracker.name}_labelled.csv")
    xyz_to_trc(xyz, tracker=tracker, target_path=output_dir / f"xyz_{tracker.name}.trc")
