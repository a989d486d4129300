"""Port of caliscope_tpu/gui/views/__init__.py."""

from caliscope_tpu_torch.gui.views.cameras_tab import CamerasTabWidget
from caliscope_tpu_torch.gui.views.extract_view import ExtractView
from caliscope_tpu_torch.gui.views.extrinsic_view import ExtrinsicCalibrationView
from caliscope_tpu_torch.gui.views.intrinsic_view import IntrinsicCalibrationView
from caliscope_tpu_torch.gui.views.project_view import ProjectSetupView
from caliscope_tpu_torch.gui.views.reconstruct_view import ReconstructionView

__all__ = [
    "CamerasTabWidget",
    "ExtractView",
    "ExtrinsicCalibrationView",
    "IntrinsicCalibrationView",
    "ProjectSetupView",
    "ReconstructionView",
]
