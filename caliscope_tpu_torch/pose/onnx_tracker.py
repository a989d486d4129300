"""Generic ONNX pose tracker driven by a model card.

Port of caliscope_tpu/pose/onnx_tracker.py: letterbox preprocessing,
per-camera bbox tracking state, the scan-positions fallback and rotation
handling, with the model run by the port's own executor
(pose/onnx_torch.py::OnnxTorchSession) on `device` and decoded there
(pose/decode.py). There is no engine switch and no onnxruntime.

`letterbox` resizes on the device as cv2.resize(INTER_LINEAR) resizes 8-bit
frames (the JAX package calls OpenCV, which the GPU machine does not have):
11-bit fixed-point weights from float32 source coordinates, an integer
horizontal pass and OpenCV's vectorized vertical rounding
((S0 >> 4) * b0 >> 16 + (S1 >> 4) * b1 >> 16 + 2) >> 2; an exact 2x
downscale in both axes averages 2 x 2 blocks, as OpenCV switches to
INTER_AREA there. OpenCV rounds a few pixels in its scalar code paths the
other way, so the canvas is within 1 gray level of cv2's (held by
tests/test_torch_onnx_tracker.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.packets import PixelFormat, PointPacket
from caliscope_tpu_torch.pose.decode import decode_heatmap, decode_simcc
from caliscope_tpu_torch.pose.model_card import ModelCard
from caliscope_tpu_torch.tracker import Tracker, WireFrameView

ENGINE = "torch"
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def create_inference_session(model_path, engine: str = ENGINE, device=None):
    """The port's executor (OnnxTorchSession) for an .onnx model on `device`
    (CUDA unless named). `engine` names the executor; the port has only
    "torch". A model with ops the executor lacks is refused."""
    from caliscope_tpu_torch.pose.onnx_proto import load_model
    from caliscope_tpu_torch.pose.onnx_torch import OnnxTorchSession, _Executor

    if engine != ENGINE:
        raise CalibrationError(f"Unknown inference engine {engine!r}; the port runs models with {ENGINE!r} only.")
    model = load_model(model_path)
    missing = sorted({n.op_type for n in model.graph.nodes if not hasattr(_Executor, f"op_{n.op_type}")})
    if missing:
        raise CalibrationError(
            f"The torch ONNX executor does not implement: {', '.join(missing)} (model {model_path})."
        )
    return OnnxTorchSession(model, device=device)


@dataclass
class _BBox:
    x0: float
    y0: float
    x1: float
    y1: float

    def expand(self, frac: float, w: int, h: int) -> "_BBox":
        dx = (self.x1 - self.x0) * frac
        dy = (self.y1 - self.y0) * frac
        return _BBox(
            max(0.0, self.x0 - dx), max(0.0, self.y0 - dy),
            min(float(w), self.x1 + dx), min(float(h), self.y1 + dy),
        )


def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: source index pairs and
    their 11-bit weights (float32 source coordinates, clamped at the
    edges, weights rounded half to even)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    edge = (s < 0) | (s >= src - 1)
    f[edge] = 0
    s = np.clip(s, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear_u8(img: torch.Tensor, nw: int, nh: int) -> torch.Tensor:
    """(h, w, c) uint8 -> (nh, nw, c) uint8, as cv2.resize(INTER_LINEAR)."""
    h, w = img.shape[:2]
    dev = img.device
    I = img.to(torch.int64)
    if w == 2 * nw and h == 2 * nh:
        s = I[0::2, 0::2] + I[0::2, 1::2] + I[1::2, 0::2] + I[1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    xs0, xs1, a0, a1 = (torch.as_tensor(v, device=dev) for v in _linear_taps(w, nw))
    ys0, ys1, b0, b1 = (torch.as_tensor(v, device=dev) for v in _linear_taps(h, nh))
    H = I[:, xs0] * a0[None, :, None] + I[:, xs1] * a1[None, :, None]
    S0, S1 = H[ys0] >> 4, H[ys1] >> 4
    v = (((S0 * b0[:, None, None]) >> 16) + ((S1 * b1[:, None, None]) >> 16) + 2) >> 2
    return torch.clamp(v, 0, 255).to(torch.uint8)


def letterbox(frame: np.ndarray, box: _BBox, out_w: int, out_h: int, device=None):
    """Crop box -> aspect-preserving resize onto a padded canvas, on
    `device`.

    Returns (canvas (out_h, out_w, 3) float32 tensor, scale, offset (2,))
    with image_xy = offset + model_xy / scale.
    """
    device = resolve_device(device)
    x0, y0 = int(box.x0), int(box.y0)
    x1, y1 = int(np.ceil(box.x1)), int(np.ceil(box.y1))
    crop = frame[y0:y1, x0:x1]
    if crop.ndim == 2:
        crop = np.repeat(crop[..., None], 3, axis=2)
    ch, cw = crop.shape[:2]
    if ch == 0 or cw == 0:
        return torch.zeros((out_h, out_w, 3), dtype=torch.float32, device=device), 1.0, np.zeros(2)
    if crop.dtype != np.uint8:
        raise CalibrationError(f"OnnxTracker takes 8-bit frames, got {crop.dtype}")
    scale = min(out_w / cw, out_h / ch)
    nw, nh = int(round(cw * scale)), int(round(ch * scale))
    resized = resize_linear_u8(torch.as_tensor(np.ascontiguousarray(crop), device=device), nw, nh)
    canvas = torch.zeros((out_h, out_w, 3), dtype=torch.float32, device=device)
    px, py = (out_w - nw) // 2, (out_h - nh) // 2
    canvas[py : py + nh, px : px + nw] = resized.to(torch.float32)
    offset = np.array([x0 - px / scale, y0 - py / scale])
    return canvas, scale, offset


class OnnxTracker(Tracker):
    """Model-card-driven pose tracker with per-camera bbox tracking, the
    model run on `device` (CUDA unless named)."""

    def __init__(self, card: ModelCard, device=None):
        self.card = card
        if not card.onnx_exists:
            raise CalibrationError(
                f"Model file not found: {card.model_path}. Point the card at an existing .onnx file."
            )
        self.device = resolve_device(device)
        self._session = create_inference_session(card.model_path, device=self.device)
        self._input_name = self._session.get_inputs()[0].name
        self._bbox: dict[int, Optional[_BBox]] = {}

    @property
    def name(self) -> str:
        return self.card.name.upper().replace(" ", "_").replace("-", "_")

    @property
    def pixel_format(self) -> PixelFormat:
        return PixelFormat.BGR

    @property
    def wireframe(self) -> Optional[WireFrameView]:
        return self.card.wireframe

    def _scan_boxes(self, w: int, h: int) -> list[_BBox]:
        """Full-frame + centered crops fallback when tracking is lost."""
        full = _BBox(0, 0, w, h)
        cx, cy = w / 2, h / 2
        half = min(w, h) / 2
        center = _BBox(cx - half, cy - half, cx + half, cy + half)
        return [full, center]

    def _infer(self, frame: np.ndarray, box: _BBox):
        canvas, scale, offset = letterbox(frame, box, self.card.input_width, self.card.input_height, self.device)
        blob = canvas.permute(2, 0, 1)[None]  # NCHW, BGR as the RTMPose SDK expects
        outputs = self._session.forward({self._input_name: blob})
        if self.card.format == "simcc":
            kps, conf = decode_simcc(outputs[0], outputs[1])
        elif self.card.format == "heatmap":
            hm = outputs[0]
            kps, conf = decode_heatmap(hm if hm.ndim == 4 else hm[None])
        else:
            raise CalibrationError(f"Unknown model output format: {self.card.format}")
        kps = kps[0].cpu().numpy()
        conf = conf[0].cpu().numpy()
        img_xy = offset[None, :] + kps / scale
        return img_xy, conf

    def _detect(self, frame: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> PointPacket:
        rot = rotation_count % 4
        work = np.rot90(frame, k=-rot) if rot else frame
        h, w = work.shape[:2]

        boxes = []
        tracked = self._bbox.get(cam_id)
        if tracked is not None:
            boxes.append(tracked.expand(0.15, w, h))
        boxes += self._scan_boxes(w, h)

        best = None
        for box in boxes:
            img_xy, conf = self._infer(work, box)
            good = conf >= self.card.confidence_threshold
            if best is None or good.sum() > best[2].sum():
                best = (img_xy, conf, good)
            if good.sum() >= 0.5 * len(conf):
                break
        img_xy, conf, good = best

        if good.any():
            pts = img_xy[good]
            self._bbox[cam_id] = _BBox(pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
        else:
            self._bbox[cam_id] = None
            return PointPacket.empty()

        kp_ids = np.flatnonzero(good)
        xy = img_xy[good]
        if rot:
            xy = self._unrotate(xy, rot, frame.shape[:2], work.shape[:2])
        return PointPacket(
            object_id=np.zeros(len(kp_ids), np.int64),
            keypoint_id=kp_ids.astype(np.int64),
            img_loc=xy,
            obj_loc=None,
            confidence=conf[good],
        )

    @staticmethod
    def _unrotate(xy: np.ndarray, rot: int, orig_shape, work_shape) -> np.ndarray:
        """Map coords from the rotated working frame back to the original."""
        out = xy.copy()
        wh, ww = work_shape
        for _ in range(rot):
            # work = rot90(orig, k=-1) one step: orig_x = y, orig_y = (W_work - 1) - x
            out = np.stack([out[:, 1], ww - 1 - out[:, 0]], axis=1)
            wh, ww = ww, wh
        return out

    def get_point_name(self, keypoint_id: int) -> str:
        return self.card.keypoint_id_to_name.get(int(keypoint_id), f"kp_{keypoint_id}")

    def get_connected_points(self) -> set[tuple[int, int]]:
        if self.card.wireframe is None:
            return set()
        return set(self.card.wireframe.edges_by_id())

    def cleanup(self) -> None:
        self._session = None
