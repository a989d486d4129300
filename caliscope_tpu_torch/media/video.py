"""Video decode: forward-only FrameSource + metadata probe + overlay
writer.

Port of caliscope_tpu/media/video.py (reference
src/caliscope/recording/frame_source.py:28-222, video_utils.py
read_video_properties:26, overlay_video_writer.py OverlayVideoWriter:27).

The JAX package decodes through OpenCV's FFmpeg on the host. The port
locates samples with its own container reader (`media/quicktime.py`) and
decodes them by codec:

- uncompressed 8-bit QuickTime video (grey, RGB or BGR) is read on the host
  on every device; its GRAY and BGR frames equal OpenCV's `read()` and
  `cvtColor(BGR2GRAY)` of the same file bit for bit;
- MJPEG decodes on the CUDA device through nvJPEG (`media/nvjpeg.py`), or
  with `device="cpu"` through the numpy decoder (`media/jpeg.py`);
- MPEG-4 Part 2 and H.264 decode on the CUDA device's NVDEC engines
  (`media/nvdec.py`) and on no other device.

A compressed frame is turned into BGR or grey as the JAX package's OpenCV
would (`media/colour.py`, within 2 grey levels of swscale) on the device
that decoded it, and reaches the caller as one numpy frame (one
device-to-host copy). Any other codec raises CalibrationError naming it
and the ffmpeg command that converts the file.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.media import colour
from caliscope_tpu_torch.media.quicktime import CODEC_NAMES, RawQuickTimeWriter, conversion_hint, read_track
from caliscope_tpu_torch.packets import FramePacket, PixelFormat
from caliscope_tpu_torch.tracing import span

logger = logging.getLogger(__name__)

def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W) uint8, as cv2.cvtColor(BGR2GRAY)
    (OpenCV 5's 15-bit weights; equal to it on all 2^24 colours)."""
    return colour.bgr_to_gray(torch.from_numpy(np.ascontiguousarray(bgr))).numpy()


@dataclass(frozen=True)
class VideoProperties:
    path: Path
    width: int
    height: int
    fps: float
    frame_count: int

    @property
    def size(self) -> tuple[int, int]:
        return (self.width, self.height)


def read_video_properties(path: Path | str) -> VideoProperties:
    """Size/fps/frame_count from the container's tables (no frame is read);
    fps 30.0 when the track states no duration."""
    path = Path(path)
    track = read_track(path)
    return VideoProperties(path, track.width, track.height, track.fps or 30.0, track.frame_count)


# JPEG frames nvJPEG decodes in one call
JPEG_BATCH = 8


def _needed_samples(track, wanted: Optional[set[int]]) -> np.ndarray:
    """(n,) bool over decode order: the samples a decode of the wanted
    frames must read, each wanted sample and, on an inter-coded track, the
    samples from the last sync sample at or before it."""
    n = track.frame_count
    if wanted is None:
        return np.ones(n, bool)
    shown = np.zeros(n, bool)
    picks = np.fromiter((i for i in wanted if 0 <= i < n), np.int64)
    shown[picks] = True
    hit = shown[track.display]  # by decode position
    if track.intra_only:
        return hit
    pos = np.arange(n)
    last_sync = np.maximum.accumulate(np.where(track.sync, pos, 0))
    edges = np.zeros(n + 1, np.int64)
    np.add.at(edges, last_sync[hit], 1)
    np.add.at(edges, pos[hit] + 1, -1)
    return np.cumsum(edges[:n]) > 0


class FrameSource:
    """Forward-only reader yielding FramePackets.

    device: where compressed frames decode, CUDA unless the caller names
    another; MJPEG also decodes on the CPU, MPEG-4 Part 2 and H.264 only on
    CUDA. Uncompressed files are host reads on every device.

    wanted_indices: frames outside the set are skipped. An uncompressed or
    intra-only track (every sample a sync sample: MJPEG, all-IDR H.264) is
    not read there at all; an inter-coded track decodes, for each wanted
    frame, from the last sync sample at or before it, and converts only the
    wanted frames. GRAY output of a colour file converts once per wanted
    frame. Thread-safe: one internal lock.
    """

    def __init__(
        self,
        path: Path | str,
        cam_id: int,
        *,
        wanted_indices: Optional[set[int]] = None,
        pixel_format: PixelFormat = PixelFormat.BGR,
        frame_times: Optional[dict[int, float]] = None,
        fps_fallback: float = 30.0,
        decode_threads: Optional[int] = None,
        device=None,
    ):
        """decode_threads is the reference's per-stream decoder thread budget
        (frame_source.py:28-76); the port's decoders are the card's engines
        or one host thread, so it does nothing here and is kept for the
        callers' signature."""
        self.path = Path(path)
        self.cam_id = cam_id
        self.pixel_format = pixel_format
        self.wanted_indices = wanted_indices
        self._frame_times = frame_times
        self._track = t = read_track(self.path)
        self._fps = t.fps or fps_fallback
        self._next_index = 0
        self._lock = threading.Lock()
        self.device = None if t.codec == "raw" else self._decode_device(device)
        self._needed = _needed_samples(t, wanted_indices)  # by decode position
        self._fed = 0  # next sample, in decode order, the decoder has not been given
        self._flushed = False  # NVDEC's parser was told the stream ended
        self._ready: dict[int, np.ndarray] = {}  # decoded, converted wanted frames by index
        self._nvjpeg = self._nvdec = None
        self._f = open(self.path, "rb")
        try:
            if self.device is not None and self.device.type == "cuda":
                if t.codec == "jpeg":
                    from caliscope_tpu_torch.media.nvjpeg import NvJpegDecoder

                    self._nvjpeg = NvJpegDecoder(self.device)
                else:
                    from caliscope_tpu_torch.media.nvdec import NvdecDecoder

                    self._nvdec = NvdecDecoder(t.codec, t.extradata, (t.width, t.height), self.device,
                                               nal_length_size=t.nal_length_size, wanted=wanted_indices)
        except BaseException:
            self._f.close()
            raise

    def _decode_device(self, device) -> torch.device:
        t, name = self._track, CODEC_NAMES[self._track.codec]
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cpu" and t.codec != "jpeg":
            raise CalibrationError(
                f"{self.path}: {name} video decodes only on the CUDA device (NVDEC), not on the CPU; "
                f"decode it on the card, or convert with: {conversion_hint(self.path)}"
            )
        if dev.type == "cuda" and not torch.cuda.is_available():
            also = " or pass device='cpu'" if t.codec == "jpeg" else ""
            raise CalibrationError(
                f"{self.path}: {name} video decodes on the CUDA device and none is available; "
                f"run on a GPU{also}, or convert with: {conversion_hint(self.path)}"
            )
        if dev.type not in ("cpu", "cuda"):
            raise CalibrationError(f"{self.path}: {name} video does not decode on {dev}")
        return dev

    @classmethod
    def from_path(cls, path: Path | str, cam_id: int = 0, **kwargs) -> "FrameSource":
        return cls(path, cam_id, **kwargs)

    def _time_for(self, index: int) -> float:
        if self._frame_times is not None and index in self._frame_times:
            return self._frame_times[index]
        return index / self._fps

    def _sample(self, d: int) -> bytes:
        t = self._track
        self._f.seek(int(t.offsets[d]))
        data = self._f.read(int(t.sizes[d]))
        if len(data) != int(t.sizes[d]):
            raise EOFError(f"{self.path}: sample {d} is cut short")
        return data

    def _read(self, index: int) -> np.ndarray:
        t = self._track
        buf = bytearray(t.frame_bytes)
        self._f.seek(int(t.offsets[index]))
        if self._f.readinto(buf) != len(buf):
            raise EOFError(f"{self.path}: frame {index} is cut short")
        rows = np.frombuffer(buf, np.uint8).reshape(t.height, t.stride)[:, : t.width * t.channels]
        if t.channels == 1:
            gray = np.invert(rows)  # QuickTime's 8-bit grey stores white as 0
            if self.pixel_format is PixelFormat.GRAY:
                return gray
            return np.repeat(gray[:, :, None], 3, axis=2)
        pix = rows.reshape(t.height, t.width, 3)
        bgr = pix[:, :, ::-1] if t.order == "rgb" else pix
        if self.pixel_format is PixelFormat.GRAY:
            return bgr_to_gray(bgr)
        return np.ascontiguousarray(bgr)

    def _convert(self, y, u, v, full_range: bool) -> np.ndarray:
        return colour.yuv_to_frame(y, u, v, full_range, self.pixel_format is PixelFormat.GRAY).cpu().numpy()

    def _decode_more(self) -> bool:
        """Decode the next needed samples into `_ready`. False once every
        needed sample has been decoded (the decoder flushed)."""
        t, needed = self._track, self._needed
        ahead = np.flatnonzero(needed[self._fed :]) + self._fed
        if len(ahead) == 0:
            if self._nvdec is not None and not self._flushed:
                self._nvdec.end()
                self._flushed = True
                self._collect_nvdec()
            return False
        if t.codec == "jpeg":
            batch = ahead[: JPEG_BATCH if self._nvjpeg is not None else 1].tolist()
            data = [self._sample(d) for d in batch]
            if self._nvjpeg is not None:
                planes = self._nvjpeg.decode(data)
                for j, d in enumerate(batch):
                    y, *uv = (p[j] for p in planes)
                    self._ready[int(t.display[d])] = self._convert(y, *(uv or (None, None)), True)
            else:
                from caliscope_tpu_torch.media import jpeg

                img = jpeg.decode(data[0])
                y, *uv = (torch.from_numpy(p) for p in img.planes)
                self._ready[int(t.display[batch[0]])] = self._convert(y, *(uv or (None, None)), True)
            self._fed = batch[-1] + 1
            return True
        d = int(ahead[0])
        self._nvdec.feed(self._sample(d), int(t.display[d]))
        self._fed = d + 1
        self._collect_nvdec()
        return True

    def _collect_nvdec(self) -> None:
        dec = self._nvdec
        for index in sorted(dec.frames):
            y, uv = dec.pop(index)
            self._ready[index] = self._convert(y, uv[..., 0], uv[..., 1], dec.full_range)

    def _frame(self, index: int) -> np.ndarray:
        if self._track.codec == "raw":
            return self._read(index)
        while index not in self._ready:
            if not self._decode_more():
                if index not in self._ready:
                    raise CalibrationError(f"{self.path}: frame {index} did not decode")
        return self._ready.pop(index)

    def next_frame(self) -> Optional[FramePacket]:
        """Next wanted frame, or None at end of stream."""
        with span("media.next_frame"), self._lock:
            while self._next_index < self._track.frame_count:
                idx = self._next_index
                self._next_index += 1
                if self.wanted_indices is not None and idx not in self.wanted_indices:
                    continue
                return FramePacket(
                    cam_id=self.cam_id,
                    frame_index=idx,
                    frame_time=self._time_for(idx),
                    frame=self._frame(idx),
                    pixel_format=self.pixel_format,
                )
            return None

    def __iter__(self) -> Iterator[FramePacket]:
        while True:
            pkt = self.next_frame()
            if pkt is None:
                return
            yield pkt

    def close(self) -> None:
        with self._lock:
            self._f.close()
            for dec in (self._nvdec, self._nvjpeg):
                if dec is not None:
                    dec.close()
            self._nvdec = self._nvjpeg = None
            self._ready.clear()

    def __enter__(self) -> "FrameSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_gray_video(path: Path | str, frames, fps: float = 30.0) -> None:
    """Write (H, W) uint8 frames as grey 8-bit uncompressed QuickTime, the
    layout `FrameSource` reads without conversion."""
    frames = iter(frames)
    first = np.asarray(next(frames))
    with RawQuickTimeWriter(path, (first.shape[1], first.shape[0]), fps, "gray") as w:
        w.write(first)
        for frame in frames:
            w.write(frame)


def _draw_dot(frame: np.ndarray, x: int, y: int, radius: int, color) -> None:
    """Fill the disc of `radius` around (x, y) in a (H, W, 3) frame."""
    h, w = frame.shape[:2]
    y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
    x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    frame[y0:y1, x0:x1][(yy - y) ** 2 + (xx - x) ** 2 <= radius * radius] = color


class OverlayVideoWriter:
    """QA artifact: per-camera video with tracked points drawn on each frame
    (reference overlay_video_writer.py:27). Written as uncompressed 24-bit
    RGB QuickTime under the name it is given (the JAX package writes mp4v);
    frames come in as BGR or grey, dots are filled discs."""

    def __init__(self, out_path: Path | str, size: tuple[int, int], fps: float):
        self._writer = RawQuickTimeWriter(out_path, size, fps, "rgb")

    def write(self, frame: np.ndarray, points: Optional[np.ndarray] = None, radius: int = 4) -> None:
        if frame.ndim == 2:
            frame = np.repeat(frame[:, :, None], 3, axis=2)
        else:
            frame = frame.copy()
        if points is not None:
            for x, y in np.asarray(points).reshape(-1, 2):
                if np.isfinite(x) and np.isfinite(y):
                    _draw_dot(frame, int(round(x)), int(round(y)), radius, (0, 220, 40))
        self._writer.write(frame[:, :, ::-1])

    def close(self) -> None:
        self._writer.close()

    def __enter__(self) -> "OverlayVideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
