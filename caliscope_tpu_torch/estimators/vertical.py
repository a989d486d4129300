"""Per-camera vertical (gravity "up") estimation from footage.

Port of caliscope_tpu/estimators/vertical.py: the GeoCalib perspective-field
network's model spec and downloader (`ensure_model`), the per-frame up-field
inference (`_infer_up_field`), and the aggregation of per-frame gravity
fits into a per-camera up vector (`estimate_vertical_from_fields`).

The JAX package resizes each frame with cv2.resize and swaps its channels
with cv2.cvtColor, then runs the network on the host's executor. The port
resizes on the session's device as cv2.resize(INTER_LINEAR) does
(pose/onnx_tracker.py::resize_linear_u8, within 1 gray level of OpenCV),
swaps the channels in torch and runs the network through the port's
executor (OnnxTorchSession). Its frames path, `estimate_vertical_from_frames`,
takes decoded frames; `estimate_vertical` reads them from video files
through the port's media layer (uncompressed QuickTime, media/video.py).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.estimators.vertical_solver import GravityFit, fit_gravity

logger = logging.getLogger(__name__)

# Public GeoCalib perspective-field export (the model the reference pins).
GEOCALIB_URL = "https://github.com/mprib/caliscope/releases/download/v0.9.0/geocalib_perspective_fields.onnx"
GEOCALIB_FILENAME = "geocalib_perspective_fields.onnx"

# GeoCalib's fixed preprocessing geometry: frames are resized so the short
# side is 320 with both edges multiples of 32 before entering the network.
NET_SHORT_SIDE = 320
EDGE_MULTIPLE = 32

# The four dense outputs the network emits, in the ONNX graph's output
# order (estimators/geocalib_arch.py emits exactly this contract).
FIELD_NAMES = ("up_field", "up_confidence", "latitude_field", "latitude_confidence")


@dataclass(frozen=True)
class VerticalEstimate:
    """Per-camera up vector (camera frame, unit) + agreement diagnostics."""

    up_by_camera: dict[int, np.ndarray]
    residual_deg_by_camera: dict[int, float]
    n_frames_by_camera: dict[int, int]

    @property
    def cam_ids(self) -> list[int]:
        return sorted(self.up_by_camera)


def ensure_model(models_dir: Path | str) -> Path:
    """The perspective-field model's path under `models_dir`, downloaded
    first if absent."""
    from caliscope_tpu_torch.pose.model_card import ModelCard
    from caliscope_tpu_torch.pose.model_download import ensure_model as _ensure

    models_dir = Path(models_dir)
    card = ModelCard(
        name="GeoCalib perspective fields",
        model_path=models_dir / GEOCALIB_FILENAME,
        format="heatmap",
        input_width=320,
        input_height=240,
        confidence_threshold=0.0,
        point_name_to_id={},
        wireframe=None,
        source_url=GEOCALIB_URL,
        extraction="direct",
    )
    return _ensure(card)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _infer_up_field(session, frame: np.ndarray) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Run the perspective-field network on one 8-bit BGR (or gray) frame
    on the session's device -> (up_field (H, W, 2), weights (H, W) or None),
    as host arrays at the network's input size."""
    from caliscope_tpu_torch.pose.onnx_tracker import resize_linear_u8

    if frame.dtype != np.uint8:
        raise CalibrationError(f"The vertical estimator takes 8-bit frames, got {frame.dtype}")
    inp = session.get_inputs()[0]
    _n, _c, h, w = inp.shape
    img = torch.as_tensor(np.ascontiguousarray(frame), device=session.device)
    gray = img.ndim == 2
    img = resize_linear_u8(img[..., None] if gray else img, int(w), int(h))
    img = img.expand(-1, -1, 3) if gray else img.flip(-1)  # GRAY2RGB / BGR2RGB
    blob = (img.to(torch.float32) / 255.0).permute(2, 0, 1)[None].contiguous()
    outputs = session.forward({inp.name: blob})
    up = _host(outputs[0])[0]  # (2, h, w) expected
    field = np.moveaxis(up[:2], 0, -1)
    weights = None
    if len(outputs) > 1:
        conf = _host(outputs[1])[0]
        weights = conf[0] if conf.ndim == 3 else conf
    return field, weights


def estimate_vertical_from_fields(
    fields_by_camera: Mapping[int, list[np.ndarray]],
    K_by_camera: Mapping[int, np.ndarray],
    device=None,
    dtype=None,
) -> VerticalEstimate:
    """Aggregate per-frame gravity fits (on `device`, CUDA unless named)
    into a per-camera up vector.

    fields are (H, W, 2) up-fields in each camera's (possibly resized) frame;
    K must correspond to the field resolution.
    """
    ups: dict[int, np.ndarray] = {}
    residuals: dict[int, float] = {}
    counts: dict[int, int] = {}
    for cid, fields in fields_by_camera.items():
        fits: list[GravityFit] = [
            fit_gravity(f, np.asarray(K_by_camera[cid]), device=device, dtype=dtype) for f in fields
        ]
        good = [f for f in fits if f.inlier_fraction > 0.5]
        if not good:
            logger.warning(f"Camera {cid}: no usable gravity fits; skipping")
            continue
        vecs = np.stack([f.gravity_cam for f in good])
        # robust average on the sphere: normalize the mean after sign alignment
        ref = vecs[0]
        vecs = vecs * np.sign(vecs @ ref)[:, None]
        mean = vecs.mean(axis=0)
        mean /= np.linalg.norm(mean)
        # camera "up" is opposite gravity
        ups[cid] = -mean
        residuals[cid] = float(np.median([f.residual_deg for f in good]))
        counts[cid] = len(good)
    if not ups:
        raise CalibrationError("Vertical estimation produced no usable per-camera fits.")
    return VerticalEstimate(ups, residuals, counts)


def estimate_vertical_from_frames(
    frames_by_camera: Mapping[int, list[np.ndarray]],
    K_by_camera: Mapping[int, np.ndarray],
    models_dir: Path | str,
    device=None,
    dtype=None,
) -> VerticalEstimate:
    """Decoded frames -> perspective-field network -> gravity fits, on
    `device` (CUDA unless named). Each camera's K is for its frames' size
    and is rescaled to the field's. The model is downloaded on first use."""
    from caliscope_tpu_torch.pose.onnx_tracker import create_inference_session

    session = create_inference_session(ensure_model(models_dir), device=device)
    fields: dict[int, list[np.ndarray]] = {}
    Ks: dict[int, np.ndarray] = {}
    for cid, frames in frames_by_camera.items():
        cam_fields = []
        for frame in frames:
            field, _w = _infer_up_field(session, frame)
            cam_fields.append(field)
            if len(cam_fields) == 1:
                fh, fw = field.shape[:2]
                K = np.asarray(K_by_camera[cid], dtype=float).copy()
                K[0] *= fw / frame.shape[1]
                K[1] *= fh / frame.shape[0]
                Ks[cid] = K
        fields[cid] = cam_fields
    return estimate_vertical_from_fields(fields, Ks, device=device, dtype=dtype)


def estimate_vertical(
    videos: Mapping[int, Path],
    K_by_camera: Mapping[int, np.ndarray],
    models_dir: Path | str,
    n_sample_frames: int = 6,
    device=None,
    dtype=None,
) -> VerticalEstimate:
    """Full path: `n_sample_frames` frames spread over each video (BGR) ->
    `estimate_vertical_from_frames` on `device` (CUDA unless named). The
    model is downloaded on first use."""
    from caliscope_tpu_torch.media import FrameSource, read_video_properties

    frames: dict[int, list[np.ndarray]] = {}
    for cid, video in videos.items():
        props = read_video_properties(video)
        wanted = set(np.linspace(0, max(props.frame_count - 1, 0), n_sample_frames, dtype=int).tolist())
        with FrameSource(video, cid, wanted_indices=wanted, device=device) as src:
            frames[cid] = [pkt.frame for pkt in src]
    return estimate_vertical_from_frames(frames, K_by_camera, models_dir, device=device, dtype=dtype)
