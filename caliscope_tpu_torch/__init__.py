"""caliscope_tpu_torch: the PyTorch/CUDA port of caliscope_tpu.

The port grows slice by slice beside the JAX package (`caliscope_tpu/`),
which stays the reference every module here is held against (ROADMAP.md).

Slice 1 carries the bundle-adjustment solve: cameras and observations,
triangulation, the dense point-minor reprojection blocks, the
Levenberg-Marquardt loop with its Schur solve, and `CaptureVolume.optimize`
/ `filter_by_percentile_error`. The Schur assembly runs as a hand-written
CUDA kernel (`csrc/schur_s_rhs.cu`, bound in `solvers/fused_schur.py`).

Slice 2 carries ChArUco detection, frames to `PointPacket`s through
`trackers.CharucoTracker`, with its labeling, ring-response and
window-gather kernels (`csrc/ccl.cu`, `csrc/corner_response.cu`,
`csrc/extract_windows.cu`, bound in `detect/ccl.py` and
`detect/cuda_kernels.py`).

Slice 3 carries the extrinsic calibration pipeline from cameras without
extrinsics (`pipelines.calibrate_extrinsics`): batched PnP (`ops/pnp.py`),
RANSAC (`ops/epipolar.py`), the pose network (`solvers/pose_network.py`),
`CaptureVolume.bootstrap` and the synthetic scene engine (`synthetic/`);
its BA stages run through the Schur kernel.

Slice 4 carries the constrained production flow: rigidity constraints
(`constraints.py`, `ConstraintSet.from_charuco`), constrained bundle
adjustment, the sparse row layout (row-major and obs-minor) for static
markers and chained co-visibility, and the 'cg' / 'schur_cg' solvers; these
run as plain tensor operations (the Schur kernel takes only dense
reprojection-only problems).

Slice 5 carries intrinsic calibration (`pipelines.run_intrinsic_calibration`:
frame selection in `frame_selector.py`, Zhang's closed form and a joint LM
in `solvers/intrinsics.py`), the chessboard and ArUco marker-set targets
with their trackers (`trackers.ChessboardTracker`, `trackers.ArucoTracker`,
which reach the ring-response, labeling and window-gather kernels one frame
a call), the extrinsic coverage analysis (`coverage.py`), the rest of
anchoring and scale QA on `CaptureVolume` (`scaled`, `oriented`,
`grounded`, `compute_volumetric_scale_accuracy`) and the synthetic fixture
repository.

Slice 6 carries the markerless path: the epipolar bootstrap
(`solvers/epipolar.py`, chosen by `calibrate_extrinsics` for observations
without obj_loc), gap filling and Butterworth smoothing
(`observations.py`, `ops/signal.py`), `reconstruction.reconstruct_xyz` with
the CSV / TRC / Blender exports (`export/`), and the first-party ONNX pose
stack (`pose/`: reader and writer, the RTMPose family, the executor
`OnnxTorchSession`, decoding and `OnnxTracker`). Its BA stages run through
the Schur kernel; the network runs as eager torch ops on the device.

Devices: every entry point (`calibrate_extrinsics`, `run_intrinsic_calibration`,
`calibrate_intrinsics`, `solve_intrinsics`, `CaptureVolume`, `lm_solve`,
`ImagePoints.triangulate`, `WorldPoints.smooth`, `reconstruct_xyz`, the
three target trackers, `OnnxTracker`, `OnnxTorchSession`, `detect_markers`,
`detect_x_corners_device`) runs on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device it raises instead of falling back.
The solves' float dtype follows the device unless given: float32 on CUDA,
float64 on the CPU (the JAX package's x64 parity convention). The intrinsic
solve is the exception, float64 on both: in float32 its LM never meets the
reference's stop test (solvers/intrinsics.py). Detection runs in float32 on
both, as the reference's detection does.

Process-global side effect: importing this package disables TF32 for
float32 matrix products and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``) and sets
``torch.set_float32_matmul_precision("highest")``. TF32 keeps about three
decimal digits; on a real 4-camera 720p session the JAX package measured
reduced-precision products alone moving the rig's reprojection RMSE from
0.80 px to 1.35 px (PROFILE.md, "f32 accuracy on TPU"). Nothing here
creates a CUDA context at import.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from caliscope_tpu_torch.cameras import CameraArray, CameraData  # noqa: E402,F401
from caliscope_tpu_torch.constraints import ConstraintSet  # noqa: E402,F401
from caliscope_tpu_torch.exceptions import CalibrationError, CalibrationWarning  # noqa: E402,F401
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, ImagePoints, WorldPoints  # noqa: E402,F401
