"""Calibration-target definitions of the port (host code): the ChArUco
board, the chessboard and the ArUco marker set, as in caliscope_tpu/targets/."""

from caliscope_tpu_torch.targets.charuco import ARUCO_DICTIONARY_CAPACITY, Charuco, fit_dictionary_pool  # noqa: F401
from caliscope_tpu_torch.targets.chessboard import Chessboard  # noqa: F401
from caliscope_tpu_torch.targets.aruco import ArucoMarker, ArucoMarkerSet, DistanceLink, MirrorPair  # noqa: F401
