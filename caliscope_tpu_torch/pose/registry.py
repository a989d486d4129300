"""Tracker registry: runtime mapping of tracker keys to factories.

Port of caliscope_tpu/pose/registry.py (host code). The three target
trackers register statically; ONNX model cards are discovered by scanning a
model-cards directory, each registering an OnnxTracker factory under its
file stem.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable

from caliscope_tpu_torch.pose.model_card import ModelCard
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)

_FACTORIES: dict[str, Callable[..., Tracker]] = {}


def register_tracker(key: str, factory: Callable[..., Tracker]) -> None:
    _FACTORIES[key.upper()] = factory


def tracker_factory(key: str) -> Callable[..., Tracker]:
    try:
        return _FACTORIES[key.upper()]
    except KeyError:
        raise KeyError(f"Unknown tracker '{key}'; available: {sorted(_FACTORIES)}") from None


def available_trackers() -> list[str]:
    return sorted(_FACTORIES)


def scan_onnx_models(cards_dir: Path | str, models_dir: Path | str | None = None) -> dict[str, ModelCard]:
    """Discover model cards and register OnnxTracker factories for each."""
    from caliscope_tpu_torch.pose.onnx_tracker import OnnxTracker

    cards_dir = Path(cards_dir)
    found: dict[str, ModelCard] = {}
    if not cards_dir.exists():
        return found
    for p in sorted(cards_dir.glob("*.toml")):
        try:
            card = ModelCard.from_toml(p, Path(models_dir) if models_dir else None)
        except Exception as e:
            logger.warning(f"Skipping invalid model card {p.name}: {e}")
            continue
        key = p.stem.upper()
        found[key] = card
        register_tracker(key, lambda card=card, **kw: OnnxTracker(card, **kw))
    return found


def _register_builtin() -> None:
    def charuco_factory(charuco, **kw):
        from caliscope_tpu_torch.trackers import CharucoTracker

        return CharucoTracker(charuco, **kw)

    def aruco_factory(marker_set, **kw):
        from caliscope_tpu_torch.trackers import ArucoTracker

        return ArucoTracker(marker_set, **kw)

    def chessboard_factory(chessboard, **kw):
        from caliscope_tpu_torch.trackers import ChessboardTracker

        return ChessboardTracker(chessboard, **kw)

    register_tracker("CHARUCO", charuco_factory)
    register_tracker("ARUCO", aruco_factory)
    register_tracker("CHESSBOARD", chessboard_factory)


_register_builtin()
