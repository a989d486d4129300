"""The port's playback streamer and streaming extraction
(caliscope_tpu_torch/media/streamer.py, pipelines/process_recording.py):
the scenarios of tests/test_streaming.py on uncompressed recordings written
by the port's writer, and process_synchronized_recording against the JAX
package's on the same files (the JAX package decodes them with OpenCV):
the same rows in the same order, the same live frames.
"""

from __future__ import annotations

import time
from queue import Empty

import numpy as np
import pytest

from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.media import SynchronizedTimestamps as JaxSync
from caliscope_tpu.packets import PixelFormat as JaxPixelFormat
from caliscope_tpu.packets import PointPacket as JaxPointPacket
from caliscope_tpu.pipelines.process_recording import process_synchronized_recording as jax_process
from caliscope_tpu.tracker import Tracker as JaxTracker

from caliscope_tpu_torch.cameras import CameraData
from caliscope_tpu_torch.media import SynchronizedTimestamps
from caliscope_tpu_torch.media.streamer import FramePacketStreamer
from caliscope_tpu_torch.media.video import OverlayVideoWriter
from caliscope_tpu_torch.packets import PixelFormat, PointPacket
from caliscope_tpu_torch.pipelines.process_recording import process_synchronized_recording
from caliscope_tpu_torch.tasks import CancellationToken
from caliscope_tpu_torch.tracker import Tracker


def _dot(frame):
    ys, xs = np.where(frame > 128)
    return None if len(xs) == 0 else (xs.mean(), ys.mean())


class DotTracker(Tracker):
    @property
    def name(self):
        return "DOT"

    @property
    def pixel_format(self):
        return PixelFormat.GRAY

    def _detect(self, frame, cam_id=0, rotation_count=0):
        xy = _dot(frame)
        return PointPacket.empty() if xy is None else PointPacket(np.array([0]), np.array([0]), np.array([xy]))

    def get_point_name(self, keypoint_id):
        return "dot"


class JaxDotTracker(JaxTracker):
    @property
    def name(self):
        return "DOT"

    @property
    def pixel_format(self):
        return JaxPixelFormat.GRAY

    def _detect(self, frame, cam_id=0, rotation_count=0):
        xy = _dot(frame)
        return JaxPointPacket.empty() if xy is None else JaxPointPacket(np.array([0]), np.array([0]), np.array([xy]))

    def get_point_name(self, keypoint_id):
        return "dot"


def _make_recording(d, cam_ids=(0, 1), n_frames=8, fps=30.0):
    """A white dot moving right on black, one 96x64 RGB video a camera."""
    for cid in cam_ids:
        with OverlayVideoWriter(d / f"cam_{cid}.mp4", (96, 64), fps) as w:
            for i in range(n_frames):
                frame = np.zeros((64, 96, 3), np.uint8)
                yy, xx = np.mgrid[0:64, 0:96]
                frame[(xx - 12 - 8 * i - cid) ** 2 + (yy - 32) ** 2 <= 16] = 255
                w.write(frame)
    return d


def _drain(q, want, timeout=10.0):
    got = []
    deadline = time.time() + timeout
    while len(got) < want and time.time() < deadline:
        try:
            item = q.get(timeout=1.0)
        except Empty:
            continue
        if item is None:
            break
        got.append(item)
    return got


@pytest.mark.parametrize("subsample", [1, 2])
def test_process_recording_matches_jax(tmp_path, subsample):
    rec = _make_recording(tmp_path, cam_ids=(0, 1, 2), n_frames=9)
    videos = {c: rec / f"cam_{c}.mp4" for c in (0, 1, 2)}
    got_live, want_live, progress = [], [], []
    got = process_synchronized_recording(
        rec, {c: CameraData(c, (96, 64)) for c in videos}, DotTracker(), SynchronizedTimestamps.from_video_paths(videos),
        subsample=subsample, on_progress=lambda i, n: progress.append((i, n)),
        on_frame_data=lambda si, fd: got_live.append((si, {c: (d.frame_index, d.frame.copy()) for c, d in fd.items()})),
    )
    want = jax_process(
        rec, {c: JaxCameraData(c, (96, 64)) for c in videos}, JaxDotTracker(), JaxSync.from_video_paths(videos),
        subsample=subsample,
        on_frame_data=lambda si, fd: want_live.append((si, {c: (d.frame_index, d.frame.copy()) for c, d in fd.items()})),
    )
    for col in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "frame_time"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert len(got) == 3 * len(range(0, 9, subsample))
    assert [si for si, _ in got_live] == [si for si, _ in want_live]
    for (_, g), (_, w) in zip(got_live, want_live):
        assert sorted(g) == sorted(w)
        assert all(g[c][0] == w[c][0] and np.array_equal(g[c][1], w[c][1]) for c in g)
    assert progress[-1][0] == progress[-1][1] == len(got_live)


def test_process_recording_cancelled(tmp_path):
    rec = _make_recording(tmp_path)
    synced = SynchronizedTimestamps.from_video_paths({c: rec / f"cam_{c}.mp4" for c in (0, 1)})
    token = CancellationToken()
    token.cancel()
    got = process_synchronized_recording(rec, {c: CameraData(c, (96, 64)) for c in (0, 1)}, DotTracker(), synced, token=token)
    assert len(got) == 0


def test_streams_tracked_frames(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,))
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, tracker=DotTracker(), fps_override=120.0, queue_depth=16)
    q = s.subscribe()
    s.play()
    got = _drain(q, 8)
    s.stop()
    assert [tf.frame_index for tf in got] == list(range(8))
    assert all(len(tf.points) == 1 and tf.packet.frame.ndim == 2 for tf in got)
    np.testing.assert_allclose([tf.points.img_loc[0, 0] for tf in got], [12 + 8 * i for i in range(8)], atol=1e-9)


def test_end_of_stream_sentinel(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,), n_frames=5)
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=500.0, queue_depth=16)
    q = s.subscribe()
    s.play()
    items = []
    deadline = time.time() + 10
    while time.time() < deadline:
        item = q.get(timeout=5.0)
        items.append(item)
        if item is None:
            break
    s.stop()
    assert items[-1] is None and [p.frame_index for p in items[:-1]] == list(range(5))


def test_pause_and_seek(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,))
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=200.0)
    q = s.subscribe()
    s.seek(5)
    s.play()
    first = _drain(q, 1, timeout=5)
    s.stop()
    assert first and first[0].frame_index >= 5


def test_loop_end_behavior_wraps(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,))
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=500.0, end_behavior="loop")
    q = s.subscribe()
    s.play()
    indices = []
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            item = q.get(timeout=1.0)
        except Empty:
            continue
        assert item is not None, "loop mode must never publish the end sentinel"
        indices.append(item.frame_index)
        if any(b < a for a, b in zip(indices, indices[1:])):
            break
    s.stop()
    assert any(b < a for a, b in zip(indices, indices[1:])), indices


def test_pause_end_behavior_holds(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,))
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=500.0, end_behavior="pause")
    q = s.subscribe()
    s.play()
    deadline = time.time() + 10
    while time.time() < deadline and not s._pause.is_set():
        try:
            q.get(timeout=0.5)
        except Empty:
            pass
    assert s._pause.is_set(), "end of stream should flip to paused"
    s.seek(0)
    s.play()
    got = _drain(q, 1, timeout=5)
    s.stop()
    assert got and got[0].frame_index == 0


def test_metadata_and_fps_target(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,), n_frames=12, fps=25.0)
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=30.0)
    assert s.size == (96, 64) and s.original_fps == 25.0
    assert s.last_frame_index == s.frame_count - 1 == 11
    assert s.frame_index == 0 and s.frame_time == 0.0
    s.set_fps_target(240.0)
    assert s.fps == 240.0
    s.set_fps_target(None)
    assert s.fps == 25.0
    s.seek(4)
    s.play()
    time.sleep(0.2)
    s.pause()
    time.sleep(0.1)
    assert s.frame_time == pytest.approx(s.frame_index / 25.0, rel=1e-12)
    s.stop()


def test_update_tracker_mid_playback(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,), n_frames=30)
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=60.0, end_behavior="pause")
    q = s.subscribe()
    s.play()
    time.sleep(0.15)
    s.update_tracker(DotTracker())
    gray = None
    deadline = time.time() + 10
    while time.time() < deadline and gray is None:
        try:
            item = q.get(timeout=1.0)
        except Empty:
            continue
        if item is not None and hasattr(item, "points") and item.packet.frame.ndim == 2:
            gray = item
    s.stop()
    assert gray is not None, "no GRAY tracked frames after update_tracker"


def test_unpause_and_close(tmp_path):
    rec = _make_recording(tmp_path, cam_ids=(0,), n_frames=20)
    s = FramePacketStreamer(rec / "cam_0.mp4", cam_id=0, fps_override=200.0, end_behavior="pause")
    q = s.subscribe()
    s.play()
    time.sleep(0.1)
    s.pause()
    time.sleep(0.1)
    pos = s.position
    time.sleep(0.2)
    assert s.position == pos
    s.unpause()
    moved = bool(_drain(q, 1, timeout=5))
    s.close()
    assert moved
    with pytest.raises(ValueError):
        FramePacketStreamer(rec / "cam_0.mp4", end_behavior="rewind")
