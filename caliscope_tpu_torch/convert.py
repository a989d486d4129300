"""Carry state across from the JAX package.

This system has no weights; its state is the rig and the observations. The
functions here take that state as plain numpy arrays — exported from
caliscope_tpu objects by the caller — and build the port's CameraArray,
ImagePoints and WorldPoints. Nothing here imports the JAX package.

Exporting from caliscope_tpu (in a program that has both packages):

    cams = {cid: dict(matrix=c.matrix, distortions=c.distortions,
                      rotation=c.rotation, translation=c.translation,
                      size=c.size, fisheye=c.fisheye)
            for cid, c in jax_cameras.cameras.items()}
    ip = {name: getattr(jax_points, name) for name in IMAGE_POINT_FIELDS}
    wp = {name: getattr(jax_world, name) for name in WORLD_POINT_FIELDS}
    board = dataclasses.asdict(jax_charuco)
    pairs = {key: {f: getattr(sp, f) for f in STEREO_PAIR_FIELDS}
             for key, sp in jax_network.pairs.items()}

Detection has no other state: the ArUco dictionary data is a byte-identical
copy inside the port, and packets are numpy on both sides.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
from caliscope_tpu_torch.solvers.pose_network import PairedPoseNetwork, StereoPair
from caliscope_tpu_torch.targets.charuco import Charuco

CAMERA_FIELDS = ("matrix", "distortions", "rotation", "translation", "size", "fisheye")
IMAGE_POINT_FIELDS = ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc", "frame_time")
WORLD_POINT_FIELDS = ("sync_index", "object_id", "keypoint_id", "xyz", "frame_time")
STEREO_PAIR_FIELDS = ("primary_cam_id", "secondary_cam_id", "error_score", "rotation", "translation")
CHARUCO_FIELDS = (
    "rows", "columns", "square_size_m", "aruco_scale", "dictionary", "legacy_pattern", "thickness_m", "inverted",
)


def _copy(v):
    return None if v is None else np.array(v, copy=True)


def camera_array(cameras: Mapping[int, Mapping[str, Any]]) -> CameraArray:
    """{cam_id: {field: value}} with the CAMERA_FIELDS -> CameraArray.
    rotation is (3,3) (or a Rodrigues 3-vector); unset fields may be None."""
    out = {}
    for cid, c in cameras.items():
        unknown = set(c) - set(CAMERA_FIELDS)
        if unknown:
            raise ValueError(f"camera {cid}: unknown fields {sorted(unknown)}")
        size = c.get("size")
        out[int(cid)] = CameraData(
            cam_id=int(cid),
            size=None if size is None else (int(size[0]), int(size[1])),
            matrix=_copy(c.get("matrix")),
            distortions=_copy(c.get("distortions")),
            rotation=_copy(c.get("rotation")),
            translation=_copy(c.get("translation")),
            fisheye=bool(c.get("fisheye", False)),
        )
    return CameraArray(out)


def image_points(columns: Mapping[str, Any]) -> ImagePoints:
    """Columns named as IMAGE_POINT_FIELDS (obj_loc and frame_time optional)."""
    return ImagePoints(**{k: _copy(columns.get(k)) for k in IMAGE_POINT_FIELDS})


def world_points(columns: Mapping[str, Any]) -> WorldPoints:
    """Columns named as WORLD_POINT_FIELDS (frame_time optional)."""
    return WorldPoints(**{k: _copy(columns.get(k)) for k in WORLD_POINT_FIELDS})


def charuco(fields: Mapping[str, Any]) -> Charuco:
    """The board's dataclass fields (CHARUCO_FIELDS; rows, columns and
    square_size_m are required) -> the port's Charuco."""
    unknown = set(fields) - set(CHARUCO_FIELDS)
    if unknown:
        raise ValueError(f"charuco: unknown fields {sorted(unknown)}")
    return Charuco(**dict(fields))


def stereo_pairs(pairs: Mapping[tuple[int, int], Mapping[str, Any]]) -> dict[tuple[int, int], StereoPair]:
    """{(a, b): {field: value}} with the STEREO_PAIR_FIELDS -> the port's
    StereoPairs, keyed and ordered as given."""
    out = {}
    for key, p in pairs.items():
        if set(p) != set(STEREO_PAIR_FIELDS):
            raise ValueError(f"stereo pair {key}: fields {sorted(p)}, expected {sorted(STEREO_PAIR_FIELDS)}")
        out[(int(key[0]), int(key[1]))] = StereoPair(
            int(p["primary_cam_id"]),
            int(p["secondary_cam_id"]),
            float(p["error_score"]),
            np.array(p["rotation"], dtype=np.float64).reshape(3, 3),
            np.array(p["translation"], dtype=np.float64).reshape(3),
        )
    return out


def pose_network(pairs: Mapping[tuple[int, int], Mapping[str, Any]]) -> PairedPoseNetwork:
    """A PairedPoseNetwork's pairs (as for stereo_pairs, the bridged graph
    as the JAX network holds it) -> the port's network with the same graph."""
    return PairedPoseNetwork(stereo_pairs(pairs))
