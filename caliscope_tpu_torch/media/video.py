"""Host-side video decode: forward-only FrameSource + metadata probe + overlay
writer.

Port of caliscope_tpu/media/video.py (reference
src/caliscope/recording/frame_source.py:28-222, video_utils.py
read_video_properties:26, overlay_video_writer.py OverlayVideoWriter:27).

The JAX package decodes through OpenCV's FFmpeg. The port decodes with the
container reader of `media/quicktime.py`, for the recordings that need no
codec library: uncompressed 8-bit QuickTime video (grey, RGB or BGR) under
any file name (the workspace's cam_N.mp4 names included). A compressed file
raises CalibrationError naming its codec and the ffmpeg command that
converts it. Frames are read forward from one open file; the GRAY and BGR
outputs equal OpenCV's `read()` and `cvtColor(BGR2GRAY)` of the same file
bit for bit. Decode stays on the host; frames reach the device as batched
uint8 tensors through the extraction pipelines.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from caliscope_tpu_torch.media.quicktime import RawQuickTimeWriter, read_track
from caliscope_tpu_torch.packets import FramePacket, PixelFormat

logger = logging.getLogger(__name__)

# OpenCV's fixed-point BGR -> gray weights (15 fractional bits), which
# cvtColor(COLOR_BGR2GRAY) applies to 8-bit frames: (b*3735 + g*19235 +
# r*9798 + 16384) >> 15, equal to OpenCV 5's on all 2^24 colours.
_GRAY_B, _GRAY_G, _GRAY_R, _GRAY_SHIFT = 3735, 19235, 9798, 15


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W) uint8, as cv2.cvtColor(BGR2GRAY)."""
    b, g, r = (bgr[..., i].astype(np.uint32) for i in range(3))
    return ((b * _GRAY_B + g * _GRAY_G + r * _GRAY_R + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


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


class FrameSource:
    """Forward-only reader yielding FramePackets.

    wanted_indices: frames outside the set are skipped without a read
    (uncompressed frames are independent, so no decode is needed to pass
    them). GRAY output of a colour file converts once per wanted frame.
    Thread-safe: one internal lock.
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
    ):
        """decode_threads is the reference's per-stream decoder thread budget
        (frame_source.py:28-76); an uncompressed frame is a read, not a
        decode, so it does nothing here and is kept for the callers'
        signature."""
        self.path = Path(path)
        self.cam_id = cam_id
        self.pixel_format = pixel_format
        self.wanted_indices = wanted_indices
        self._frame_times = frame_times
        self._track = read_track(self.path)
        self._fps = self._track.fps or fps_fallback
        self._next_index = 0
        self._lock = threading.Lock()
        self._f = open(self.path, "rb")

    @classmethod
    def from_path(cls, path: Path | str, cam_id: int = 0, **kwargs) -> "FrameSource":
        return cls(path, cam_id, **kwargs)

    def _time_for(self, index: int) -> float:
        if self._frame_times is not None and index in self._frame_times:
            return self._frame_times[index]
        return index / self._fps

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

    def next_frame(self) -> Optional[FramePacket]:
        """Next wanted frame, or None at end of stream."""
        with self._lock:
            while self._next_index < self._track.frame_count:
                idx = self._next_index
                self._next_index += 1
                if self.wanted_indices is not None and idx not in self.wanted_indices:
                    continue
                return FramePacket(
                    cam_id=self.cam_id,
                    frame_index=idx,
                    frame_time=self._time_for(idx),
                    frame=self._read(idx),
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
