"""Use-case pipelines: the production calibration flows.

Port of caliscope_tpu/pipelines/ (the extrinsic pipeline so far).
"""

from caliscope_tpu_torch.pipelines.calibrate_extrinsics import (  # noqa: F401
    MIN_DEPTH_RATIO_FOR_INTRINSIC_REFINEMENT,
    CalibrationRun,
    calibrate_extrinsics,
    refresh_run,
)
