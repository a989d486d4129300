"""Port of caliscope_tpu/gui/view_models/__init__.py."""

from caliscope_tpu_torch.gui.view_models.playback_view_model import (  # noqa: F401
    FrameGeometry,
    PlaybackViewModel,
)
