"""Synthetic ground-truth scene engine — the test backbone.

Port of caliscope_tpu/synthetic/ (SE3Pose, Trajectory, CalibrationObject,
CameraSynthesizer, SyntheticScene, scene factories, fault injection, the
fixture repository, the explorer presenter).
Scenes fabricate exact ground truth so the solver stack is tested end to
end deterministically. numpy throughout; projection through the port's
CameraData.
"""

from caliscope_tpu_torch.synthetic.se3 import SE3Pose  # noqa: F401
from caliscope_tpu_torch.synthetic.trajectory import Trajectory  # noqa: F401
from caliscope_tpu_torch.synthetic.calibration_object import CalibrationObject  # noqa: F401
from caliscope_tpu_torch.synthetic.camera_synthesizer import CameraSynthesizer, LensProfile  # noqa: F401
from caliscope_tpu_torch.synthetic.scene import SyntheticScene  # noqa: F401
from caliscope_tpu_torch.synthetic import factories  # noqa: F401
