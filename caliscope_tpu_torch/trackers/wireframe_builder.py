"""TOML wireframe spec -> WireFrameView.

Host-only copy of caliscope_tpu/trackers/wireframe_builder.py. Reference
src/caliscope/trackers/wireframe_builder.py:11 — a [points] name->id table plus
[segments.NAME] {color, points=[A, B]} sections become a WireFrameView for 3D
display.
"""

from __future__ import annotations

from pathlib import Path

from caliscope_tpu_torch.persistence import load_toml
from caliscope_tpu_torch.tracker import Segment, WireFrameView


def build_wireframe(spec_path: Path | str) -> WireFrameView:
    data = load_toml(spec_path)
    points = {str(k): int(v) for k, v in data.get("points", {}).items()}
    segments = tuple(
        Segment(
            name=name,
            color=seg.get("color", "w"),
            point_A=seg["points"][0],
            point_B=seg["points"][1],
            width=float(seg.get("width", 1)),
        )
        for name, seg in data.get("segments", {}).items()
    )
    return WireFrameView(segments=segments, point_names=points)
