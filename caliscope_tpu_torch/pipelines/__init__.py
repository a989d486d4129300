"""Use-case pipelines: the production calibration flows.

Port of caliscope_tpu/pipelines/ (the extrinsic and intrinsic pipelines,
and process_recording, the streaming multicamera extraction).
"""

from caliscope_tpu_torch.pipelines.calibrate_extrinsics import (  # noqa: F401
    MIN_DEPTH_RATIO_FOR_INTRINSIC_REFINEMENT,
    CalibrationRun,
    calibrate_extrinsics,
    refresh_run,
)
from caliscope_tpu_torch.pipelines.calibrate_intrinsics import (  # noqa: F401
    IntrinsicCalibrationOutput,
    IntrinsicCalibrationReport,
    IntrinsicCalibrationResult,
    calibrate_intrinsics,
    run_intrinsic_calibration,
)
