"""ONNX pose-model cards: TOML schema + loader.

Host-only copy of caliscope_tpu/pose/model_card.py ([model] / [source] /
[points] / [segments.*] sections, e.g. model_cards/rtmpose_m_halpe26.toml;
the cards in model_cards/ are copies of the JAX package's).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from caliscope_tpu_torch.exceptions import PersistenceError
from caliscope_tpu_torch.persistence import load_toml
from caliscope_tpu_torch.tracker import Segment, WireFrameView

logger = logging.getLogger(__name__)


@dataclass(frozen=True, slots=True)
class ModelCard:
    name: str
    model_path: Path
    format: str  # "simcc" | "heatmap"
    input_width: int
    input_height: int
    confidence_threshold: float
    point_name_to_id: dict[str, int]
    wireframe: Optional[WireFrameView]
    source_url: Optional[str] = None
    license_info: Optional[str] = None
    file_size_mb: Optional[float] = None
    sha256: Optional[str] = None
    extraction: Optional[str] = None  # "zip_end2end" | "direct"
    license_url: Optional[str] = None

    @property
    def keypoint_id_to_name(self) -> dict[int, str]:
        return {v: k for k, v in self.point_name_to_id.items()}

    @property
    def onnx_exists(self) -> bool:
        return self.model_path.exists()

    @property
    def has_source_url(self) -> bool:
        return self.source_url is not None

    @staticmethod
    def from_toml(path: Path | str, models_dir: Path | None = None) -> "ModelCard":
        path = Path(path)
        try:
            data = load_toml(path)
            model = data["model"]
            points = {str(k): int(v) for k, v in data.get("points", {}).items()}
            segments = []
            for seg_name, seg in data.get("segments", {}).items():
                pts = seg["points"]
                segments.append(Segment(name=seg_name, color=seg.get("color", "w"), point_A=pts[0], point_B=pts[1]))
            wireframe = WireFrameView(tuple(segments), points) if segments else None
            source = data.get("source", {})
            model_file = Path(model["model_path"])
            if not model_file.is_absolute():
                model_file = (models_dir or path.parent) / model_file
            w, h = model["input_size"]
            return ModelCard(
                name=model["name"],
                model_path=model_file,
                format=model["format"],
                input_width=int(w),
                input_height=int(h),
                confidence_threshold=float(model.get("confidence_threshold", 0.3)),
                point_name_to_id=points,
                wireframe=wireframe,
                source_url=source.get("url"),
                license_info=source.get("license"),
                file_size_mb=source.get("file_size_mb"),
                sha256=source.get("sha256"),
                extraction=source.get("extraction"),
                license_url=source.get("license_url"),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise PersistenceError(f"Invalid model card {path}: {e}") from e

    def to_toml_dict(self) -> dict:
        d: dict = {
            "model": {
                "name": self.name,
                "model_path": self.model_path.name,
                "format": self.format,
                "input_size": [self.input_width, self.input_height],
                "confidence_threshold": self.confidence_threshold,
            },
            "points": dict(self.point_name_to_id),
        }
        source = {
            k: v
            for k, v in {
                "url": self.source_url,
                "license": self.license_info,
                "file_size_mb": self.file_size_mb,
                "sha256": self.sha256,
                "extraction": self.extraction,
                "license_url": self.license_url,
            }.items()
            if v is not None
        }
        if source:
            d["source"] = source
        if self.wireframe:
            d["segments"] = {
                s.name: {"color": s.color, "points": [s.point_A, s.point_B]} for s in self.wireframe.segments
            }
        return d
