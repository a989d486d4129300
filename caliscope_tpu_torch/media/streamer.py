"""Real-time playback streamer with subscribers, pause/seek, live tracking.

Port of caliscope_tpu/media/streamer.py (host code; a tracker on the card
runs there, one frame at a time).

Parity: reference src/caliscope/recording/frame_packet_streamer.py:33-418
(FramePacketStreamer, play_worker:284) — subscriber queues with bounded
depth, pause/resume, seek (forward-only decoders reopen on backward seek),
optional tracker applied on the fly. Qt signals become plain callbacks /
queues so any frontend (GUI, notebook, web) can subscribe.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from queue import Full, Queue
from typing import Optional

from caliscope_tpu_torch.media.video import FrameSource, read_video_properties
from caliscope_tpu_torch.packets import PixelFormat, TrackedFrame
from caliscope_tpu_torch.tracing import span
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)


class FramePacketStreamer:
    """Streams TrackedFrames from one video at (approximately) capture rate."""

    def __init__(
        self,
        video_path: Path | str,
        cam_id: int = 0,
        tracker: Optional[Tracker] = None,
        fps_override: Optional[float] = None,
        queue_depth: int = 4,
        end_behavior: str = "stop",  # 'stop' | 'pause' | 'loop' at end of video
        device=None,  # where compressed frames decode: the tracker's device when None
    ):
        self.video_path = Path(video_path)
        self.cam_id = cam_id
        self.tracker = tracker
        self.device = device if device is not None else getattr(tracker, "device", None)
        props = read_video_properties(self.video_path)
        self.frame_count = props.frame_count
        self._native_fps = props.fps
        self.fps = fps_override or props.fps
        if end_behavior not in ("stop", "pause", "loop"):
            raise ValueError(f"end_behavior must be stop|pause|loop, got {end_behavior!r}")
        self.end_behavior = end_behavior
        self._queue_depth = queue_depth
        self._subscribers: list[Queue] = []
        self._lock = threading.Lock()
        self._pause = threading.Event()
        self._stop = threading.Event()
        self._seek_to: Optional[int] = None
        self._position = 0
        self._reopen = False
        self._thread: Optional[threading.Thread] = None

    # ---- subscriptions ------------------------------------------------------
    def subscribe(self) -> Queue:
        q: Queue = Queue(maxsize=self._queue_depth)
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: Queue) -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def _publish(self, item) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(item)
            except Full:
                # drop-oldest: playback must not stall on a slow consumer
                try:
                    q.get_nowait()
                    q.put_nowait(item)
                except Exception:
                    pass

    # ---- metadata (reference frame_packet_streamer.py:106-141) --------------
    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the underlying video."""
        props = read_video_properties(self.video_path)
        return (props.width, props.height)

    @property
    def original_fps(self) -> float:
        return self._native_fps

    @property
    def last_frame_index(self) -> int:
        return self.frame_count - 1

    @property
    def frame_index(self) -> int:
        return self._position

    @property
    def frame_time(self) -> float:
        """Playback time (seconds) of the current position at the file rate."""
        return self._position / max(self._native_fps, 1e-6)

    def update_tracker(self, tracker: Optional[Tracker]) -> None:
        """Swap the tracker mid-playback (reference :145). If the new
        tracker wants a different pixel format, the worker reopens the
        decoder at the current position on its next loop."""
        old_pf = self.tracker.pixel_format if self.tracker else PixelFormat.BGR
        new_pf = tracker.pixel_format if tracker else PixelFormat.BGR
        self.tracker = tracker
        if new_pf != old_pf:
            self._reopen = True

    # ---- transport ----------------------------------------------------------
    @property
    def position(self) -> int:
        return self._position

    def play(self) -> None:
        self._pause.clear()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._play_worker, daemon=True)
            self._thread.start()

    def pause(self) -> None:
        self._pause.set()

    def unpause(self) -> None:
        """Resume without (re)starting the worker thread (reference :225)."""
        self._pause.clear()

    def seek(self, frame_index: int) -> None:
        self._seek_to = max(0, min(frame_index, self.frame_count - 1))

    def set_fps_target(self, fps: Optional[float]) -> None:
        """Re-pace playback on the fly (None restores the file's rate);
        reference fps_target semantics (frame_packet_streamer.py)."""
        self.fps = fps or self._native_fps

    def stop(self) -> None:
        self._stop.set()
        self._pause.clear()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # reference :272 calls this close(); keep both names
    close = stop

    # ---- worker -------------------------------------------------------------
    def _open_source(self, start: int) -> FrameSource:
        pf = self.tracker.pixel_format if self.tracker else PixelFormat.BGR
        src = FrameSource(self.video_path, self.cam_id, pixel_format=pf, device=self.device)
        # forward-only: skip to start
        skipped = 0
        while skipped < start:
            if src.next_frame() is None:
                break
            skipped += 1
        return src

    def _play_worker(self) -> None:
        src = self._open_source(self._position)
        try:
            while not self._stop.is_set():
                if self._reopen:
                    self._reopen = False
                    src.close()
                    src = self._open_source(self._position)
                if self._seek_to is not None:
                    target = self._seek_to
                    self._seek_to = None
                    if target < self._position:
                        src.close()
                        src = self._open_source(target)
                    else:
                        while self._position < target:
                            if src.next_frame() is None:
                                break
                            self._position += 1
                    self._position = target
                if self._pause.is_set():
                    time.sleep(0.02)
                    continue
                t0 = time.perf_counter()
                with span("streamer.frame"):
                    with span("streamer.read"):
                        pkt = src.next_frame()
                        if pkt is None and self.end_behavior == "loop":
                            src.close()
                            self._position = 0
                            src = self._open_source(0)
                            continue
                    if pkt is None:
                        if self.end_behavior == "pause":
                            self._pause.set()
                            continue
                        self._publish(None)  # end-of-stream sentinel
                        break
                    self._position = pkt.frame_index + 1
                    if self.tracker is not None:
                        points = self.tracker.get_points(pkt.frame, self.cam_id)
                        self._publish(TrackedFrame(pkt, points))
                    else:
                        self._publish(pkt)
                elapsed = time.perf_counter() - t0
                interval = 1.0 / max(self.fps, 1e-3)  # re-read: retargetable live
                if elapsed < interval:
                    with span("streamer.pace", requested_s=interval - elapsed):
                        time.sleep(interval - elapsed)
        finally:
            src.close()
