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
    cam = dataclasses.asdict(jax_camera_data)
    board = dataclasses.asdict(jax_charuco)  # or a Chessboard, an ArucoMarkerSet
    pairs = {key: {f: getattr(sp, f) for f in STEREO_PAIR_FIELDS}
             for key, sp in jax_network.pairs.items()}
    constraints = dataclasses.asdict(jax_constraint_set)
    problem = {name: np.asarray(getattr(jax_problem, name)) for name in BA_PROBLEM_FIELDS}

Detection has no other state: the ArUco dictionary data is a byte-identical
copy inside the port, and packets are numpy on both sides.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.constraints import CentroidDistanceConstraint, ConstraintSet, DistanceConstraint, PointRemap
from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
from caliscope_tpu_torch.solvers.pose_network import PairedPoseNetwork, StereoPair
from caliscope_tpu_torch.targets.aruco import ArucoMarker, ArucoMarkerSet, DistanceLink, MirrorPair
from caliscope_tpu_torch.targets.charuco import Charuco
from caliscope_tpu_torch.targets.chessboard import Chessboard

CAMERA_FIELDS = ("matrix", "distortions", "rotation", "translation", "size", "fisheye")
IMAGE_POINT_FIELDS = ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc", "frame_time")
WORLD_POINT_FIELDS = ("sync_index", "object_id", "keypoint_id", "xyz", "frame_time")
STEREO_PAIR_FIELDS = ("primary_cam_id", "secondary_cam_id", "error_score", "rotation", "translation")
BA_PROBLEM_FIELDS = (
    "cam_idx", "pt_idx", "uv", "obs_mask", "K0", "dist0", "fisheye", "inv_fx", "param_free",
    "con_pa_idx", "con_pa_w", "con_pb_idx", "con_pb_w", "con_target", "con_weight",
)
CAMERA_DATA_FIELDS = (
    "cam_id", "size", "rotation_count", "error", "matrix", "distortions", "exposure", "grid_count", "ignore",
    "translation", "rotation", "fisheye",
)
CHESSBOARD_FIELDS = ("rows", "columns", "square_size_m")
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


def camera_data(fields: Mapping[str, Any]) -> CameraData:
    """One camera as `dataclasses.asdict` gives it (CAMERA_DATA_FIELDS;
    cam_id and size required) -> the port's CameraData."""
    unknown = set(fields) - set(CAMERA_DATA_FIELDS)
    if unknown:
        raise ValueError(f"camera_data: unknown fields {sorted(unknown)}")
    arrays = {"matrix", "distortions", "rotation", "translation"}
    kw = {k: (_copy(v) if k in arrays else v) for k, v in fields.items()}
    kw["size"] = (int(fields["size"][0]), int(fields["size"][1]))
    return CameraData(**kw)


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


def chessboard(fields: Mapping[str, Any]) -> Chessboard:
    """The board's dataclass fields (CHESSBOARD_FIELDS) -> the port's Chessboard."""
    unknown = set(fields) - set(CHESSBOARD_FIELDS)
    if unknown:
        raise ValueError(f"chessboard: unknown fields {sorted(unknown)}")
    return Chessboard(**dict(fields))


def aruco_marker_set(fields: Mapping[str, Any]) -> ArucoMarkerSet:
    """An ArucoMarkerSet as `dataclasses.asdict` gives it (markers, links and
    mirror pairs as dicts of their fields) -> the port's ArucoMarkerSet, in
    the same order."""
    return ArucoMarkerSet(
        dictionary=fields["dictionary"],
        markers={int(k): ArucoMarker(**m) for k, m in fields["markers"].items()},
        links=tuple(DistanceLink(**d) for d in fields.get("links", ())),
        mirror_pairs=tuple(MirrorPair(**m) for m in fields.get("mirror_pairs", ())),
    )


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


def constraint_set(fields: Mapping[str, Any]) -> ConstraintSet:
    """A ConstraintSet as `dataclasses.asdict` gives it (its constraints as
    dicts of their fields) -> the port's ConstraintSet, constraint for
    constraint in the same order."""
    return ConstraintSet(
        distances=tuple(DistanceConstraint(**d) for d in fields["distances"]),
        static_object_ids=frozenset(int(o) for o in fields["static_object_ids"]),
        centroid_distances=tuple(CentroidDistanceConstraint(**c) for c in fields.get("centroid_distances", ())),
        point_remaps=tuple(PointRemap(**r) for r in fields.get("point_remaps", ())),
        back_face_thickness_m=fields.get("back_face_thickness_m"),
    )


def ba_problem(arrays: Mapping[str, Any], device=None, dtype=None):
    """A sparse bundle-adjustment problem's arrays (BA_PROBLEM_FIELDS, rows
    as they are, already in make_problem's (point, camera) order) -> the
    port's BAProblem on `device` (CUDA unless named)."""
    from caliscope_tpu_torch.solvers.bundle import BAProblem

    if set(arrays) != set(BA_PROBLEM_FIELDS):
        raise ValueError(f"ba_problem: fields {sorted(arrays)}, expected {sorted(BA_PROBLEM_FIELDS)}")
    device = resolve_device(device)
    dtype = resolve_dtype(device, dtype)
    kinds = dict(cam_idx=torch.int64, pt_idx=torch.int64, con_pa_idx=torch.int64, con_pb_idx=torch.int64,
                 obs_mask=torch.bool, fisheye=torch.bool, param_free=torch.bool)
    tensors = {
        k: torch.as_tensor(np.array(v, copy=True), device=device, dtype=kinds.get(k, dtype)) for k, v in arrays.items()
    }
    return BAProblem(**tensors, any_fisheye=bool(np.asarray(arrays["fisheye"]).any()))


def onnx_model(data: bytes):
    """A serialized ONNX model (e.g. the JAX package's OnnxModel through its
    onnx_proto.write_model) -> the port's OnnxModel."""
    from caliscope_tpu_torch.pose.onnx_proto import parse_model

    return parse_model(bytes(data))


def rtmpose(state_dict: Mapping[str, Any], variant: str, n_keypoints: int, input_hw=(256, 192)):
    """An RTMPose of the JAX package's rtmpose_arch (its state_dict(), with
    the constructor's arguments) -> the port's RTMPose with those weights,
    in eval mode on the CPU."""
    from caliscope_tpu_torch.pose.rtmpose_arch import RTMPose

    model = RTMPose(variant=variant, n_keypoints=n_keypoints, input_hw=input_hw)
    model.load_state_dict({k: torch.as_tensor(v).cpu() for k, v in state_dict.items()})
    return model.eval()


def geocalib(state_dict: Mapping[str, Any], variant: str = "tiny", decoder_width: int = 64):
    """A GeoCalibFields of the JAX package's geocalib_arch (its state_dict(),
    with the constructor's arguments) -> the port's GeoCalibFields with
    those weights, in eval mode on the CPU."""
    from caliscope_tpu_torch.estimators.geocalib_arch import GeoCalibFields

    model = GeoCalibFields(variant=variant, decoder_width=decoder_width)
    model.load_state_dict({k: torch.as_tensor(v).cpu() for k, v in state_dict.items()})
    return model.eval()
