"""Concrete trackers of the port: ChArUco, ArUco and chessboard, as in
caliscope_tpu/trackers/. Each runs its device program on the CUDA device
unless given another (``device="cpu"``)."""

from caliscope_tpu_torch.trackers.charuco_tracker import CharucoTracker  # noqa: F401
from caliscope_tpu_torch.trackers.aruco_tracker import ArucoTracker  # noqa: F401
from caliscope_tpu_torch.trackers.chessboard_tracker import ChessboardTracker  # noqa: F401
