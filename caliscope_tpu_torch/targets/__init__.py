"""Calibration-target definitions of the port (host code). Only the ChArUco
board is here yet; the ArUco marker set and the chessboard follow with
their trackers."""

from caliscope_tpu_torch.targets.charuco import ARUCO_DICTIONARY_CAPACITY, Charuco, fit_dictionary_pool  # noqa: F401
