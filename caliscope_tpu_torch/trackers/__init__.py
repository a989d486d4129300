"""Concrete trackers of the port. Only the ChArUco tracker is here yet."""

from caliscope_tpu_torch.trackers.charuco_tracker import CharucoTracker  # noqa: F401
