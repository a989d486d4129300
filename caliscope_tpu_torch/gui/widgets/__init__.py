"""Port of caliscope_tpu/gui/widgets/__init__.py."""

from caliscope_tpu_torch.gui.widgets.camera_card import CameraThumbnailCard
from caliscope_tpu_torch.gui.widgets.camera_list import CameraListWidget
from caliscope_tpu_torch.gui.widgets.cameras_placeholder import CamerasInfoPlaceholder
from caliscope_tpu_torch.gui.widgets.link_label import LinkLabel
from caliscope_tpu_torch.gui.widgets.config_panels import ArucoSetPanel, CharucoConfigPanel, ChessboardConfigPanel
from caliscope_tpu_torch.gui.widgets.coverage_heatmap import CoverageHeatmapWidget
from caliscope_tpu_torch.gui.widgets.lens_model import LensModelWidget
from caliscope_tpu_torch.gui.widgets.model_download import ModelDownloadDialog
from caliscope_tpu_torch.gui.widgets.log_dock import LogDock
from caliscope_tpu_torch.gui.widgets.playback_3d import Playback3DWidget
from caliscope_tpu_torch.gui.widgets.quality_tabs import CalibrationQualityTabs
from caliscope_tpu_torch.gui.widgets.step_strip import CalibrationStepStrip
from caliscope_tpu_torch.gui.widgets.structural_warnings import StructuralWarningsWidget
from caliscope_tpu_torch.gui.widgets.welcome import WelcomeWidget

__all__ = [
    "ArucoSetPanel",
    "CameraListWidget",
    "CamerasInfoPlaceholder",
    "LinkLabel",
    "CameraThumbnailCard",
    "CalibrationQualityTabs",
    "CalibrationStepStrip",
    "CharucoConfigPanel",
    "ChessboardConfigPanel",
    "CoverageHeatmapWidget",
    "LensModelWidget",
    "ModelDownloadDialog",
    "LogDock",
    "Playback3DWidget",
    "StructuralWarningsWidget",
    "WelcomeWidget",
]
