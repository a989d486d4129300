"""Headless MVP presenters: the GUI's state machines without the GUI.

Port of caliscope_tpu/presenters/ (host code). Calibration and
reconstruction run on the device each presenter is given (CUDA unless the
caller passes device="cpu").

Parity: reference src/caliscope/gui/presenters/ (IntrinsicCalibrationPresenter,
ExtrinsicCalibrationPresenter — state enum + signals driving calibrate_* in
task threads with filter preview, quality tabs, origin options;
MultiCameraProcessingPresenter; ReconstructionPresenter). The reference binds
these to PySide6 QObjects; here the identical state machines emit through a
framework-agnostic Signal so any frontend (Qt, web, notebook) can subscribe —
state is always COMPUTED from internal reality, never stored separately.
"""

from caliscope_tpu_torch.presenters.signal import Signal  # noqa: F401
from caliscope_tpu_torch.presenters.extrinsic import (  # noqa: F401
    ExtrinsicCalibrationPresenter,
    ExtrinsicCalibrationState,
    FilterPreviewData,
    OriginOption,
)
from caliscope_tpu_torch.presenters.intrinsic import (  # noqa: F401
    IntrinsicCalibrationPresenter,
    IntrinsicCalibrationState,
)
from caliscope_tpu_torch.presenters.processing import (  # noqa: F401
    MultiCameraProcessingPresenter,
    ProcessingState,
    ReconstructionPresenter,
)
