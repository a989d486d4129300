"""The port's media layer (caliscope_tpu_torch/media/) held against the JAX
package's, which decodes through OpenCV (cv2), on the same files:

- a grey 8-bit QuickTime file written by cv2 (fourcc 0, isColor False,
  copied to a cam_N.mp4 name) read by both FrameSources: frames
  np.array_equal in GRAY and BGR, with wanted_indices and frame_times, the
  same indices and times;
- read_video_properties equal on cv2's file and on the port's grey and
  colour files;
- the port's writers (grey; 24-bit RGB through OverlayVideoWriter) read back
  through cv2 bit for bit, the '24BG' (BGR) layout too, and the port's BGR
  -> GRAY conversion equal to cv2.cvtColor on every colour it meets;
- an mp4v file's tables read, but FrameSource raises CalibrationError on
  the CPU (and without a GPU) naming the device and the ffmpeg conversion;
  an HEVC entry raises naming the codec;
- CameraData.undistort_frame within one grey level of the JAX package's
  cv2.remap (Brown and fisheye, grey and colour frames);
- CameraArray.from_video_metadata equal.
"""

from __future__ import annotations

import shutil
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.media import FrameSource as JaxFrameSource
from caliscope_tpu.media import read_video_properties as jax_props
from caliscope_tpu.packets import PixelFormat as JaxPixelFormat

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.media import FrameSource, read_video_properties
from caliscope_tpu_torch.media.quicktime import RawQuickTimeWriter, read_track
from caliscope_tpu_torch.media.video import OverlayVideoWriter, bgr_to_gray, write_gray_video
from caliscope_tpu_torch.packets import PixelFormat
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

N_FRAMES = 7


def _cv2_read_all(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """cv2's grey QuickTime under a workspace name, the port's grey and RGB
    files, and the frames written into each."""
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    gray = [rng.integers(0, 256, (48, 64), dtype=np.uint8) for _ in range(N_FRAMES)]
    w = cv2.VideoWriter(str(d / "cv2.mov"), 0, 30.0, (64, 48), isColor=False)
    for f in gray:
        w.write(f)
    w.release()
    shutil.copy(d / "cv2.mov", d / "cam_0.mp4")
    write_gray_video(d / "cam_1.mp4", gray, fps=25.0)
    colour = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    with OverlayVideoWriter(d / "cam_2.mp4", (64, 48), 29.97) as ow:
        for f in colour:
            ow.write(f)
    return {"cv2": (d / "cam_0.mp4", gray), "gray": (d / "cam_1.mp4", gray), "rgb": (d / "cam_2.mp4", colour)}


@pytest.mark.parametrize("kind", ["cv2", "gray", "rgb"])
@pytest.mark.parametrize("fmt", ["GRAY", "BGR"])
@pytest.mark.parametrize("wanted", [None, {0, 3, 6, 11}])
def test_frame_source_equals_the_jax_decode(files, kind, fmt, wanted):
    path, _ = files[kind]
    times = {i: 0.5 + 0.04 * i for i in range(0, N_FRAMES, 2)}
    with JaxFrameSource(path, 2, wanted_indices=wanted, pixel_format=JaxPixelFormat[fmt], frame_times=times) as src:
        want = list(src)
    with FrameSource(path, 2, wanted_indices=wanted, pixel_format=PixelFormat[fmt], frame_times=times) as src:
        got = list(src)
    assert [p.frame_index for p in got] == [p.frame_index for p in want] == sorted(
        set(range(N_FRAMES)) & (wanted if wanted is not None else set(range(N_FRAMES)))
    )
    assert [p.frame_time for p in got] == [p.frame_time for p in want]
    for g, w in zip(got, want):
        assert g.cam_id == 2 and g.pixel_format is PixelFormat[fmt]
        assert g.frame.dtype == np.uint8 and g.frame.flags.writeable
        assert np.array_equal(g.frame, w.frame)


@pytest.mark.parametrize("kind", ["cv2", "gray", "rgb"])
def test_read_video_properties_equal(files, kind):
    path, frames = files[kind]
    got, want = read_video_properties(path), jax_props(path)
    assert (got.path, got.width, got.height, got.fps, got.frame_count) == (
        want.path, want.width, want.height, want.fps, want.frame_count,
    )
    assert got.size == (64, 48) and got.frame_count == len(frames)


@pytest.mark.parametrize("kind", ["cv2", "gray", "rgb"])
def test_written_frames_read_back_through_cv2(files, kind):
    path, frames = files[kind]
    back = _cv2_read_all(path)
    assert len(back) == len(frames)
    for b, f in zip(back, frames):
        assert np.array_equal(b, f if f.ndim == 3 else np.repeat(f[:, :, None], 3, axis=2))


@pytest.mark.parametrize("width", [64, 63])
def test_grey_writer_at_odd_widths_reads_back_through_cv2(tmp_path, width):
    frames = [np.random.default_rng(i).integers(0, 256, (20, width), dtype=np.uint8) for i in range(3)]
    write_gray_video(tmp_path / "v.mp4", frames)
    assert [np.array_equal(b[:, :, 0], f) for b, f in zip(_cv2_read_all(tmp_path / "v.mp4"), frames)] == [True] * 3
    with FrameSource(tmp_path / "v.mp4", 0, pixel_format=PixelFormat.GRAY) as src:
        assert all(np.array_equal(p.frame, f) for p, f in zip(src, frames))


def test_bgr_layout_24bg(tmp_path):
    """A '24BG' sample entry stores B, G, R: cv2 and the port read it alike."""
    frames = [np.random.default_rng(5 + i).integers(0, 256, (16, 24, 3), dtype=np.uint8) for i in range(3)]
    path = tmp_path / "bgr.mov"
    with RawQuickTimeWriter(path, (24, 16), 30.0, "rgb") as w:
        for f in frames:
            w.write(f)  # the bytes of a BGR frame, in the order stored
    data = bytearray(path.read_bytes())
    at = data.index(b"raw ", data.index(b"stsd"))
    data[at : at + 4] = b"24BG"
    path.write_bytes(bytes(data))
    back = _cv2_read_all(path)
    with FrameSource(path, 0) as src:
        got = [p.frame for p in src]
    assert len(back) == len(got) == 3
    assert all(np.array_equal(b, f) and np.array_equal(g, f) for b, g, f in zip(back, got, frames))


def test_overlay_writer_draws_dots(tmp_path):
    frame = np.zeros((40, 60), np.uint8)
    with OverlayVideoWriter(tmp_path / "o.mp4", (60, 40), 30.0) as w:
        w.write(frame, np.array([[10.2, 20.0], [np.nan, 3.0], [58.0, 39.0]]), radius=3)
    (back,) = _cv2_read_all(tmp_path / "o.mp4")
    assert tuple(back[20, 10]) == (0, 220, 40) and tuple(back[39, 58]) == (0, 220, 40)
    yy, xx = np.mgrid[0:40, 0:60]
    discs = ((xx - 10) ** 2 + (yy - 20) ** 2 <= 9) | ((xx - 58) ** 2 + (yy - 39) ** 2 <= 9)
    assert np.array_equal(back.any(axis=2), discs)


def test_gray_conversion_equals_cv2():
    x = np.random.default_rng(1).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    assert np.array_equal(bgr_to_gray(x), cv2.cvtColor(x, cv2.COLOR_BGR2GRAY))


def test_compressed_video_raises_naming_the_codec(tmp_path):
    """mp4v's tables read, but its frames decode only on the CUDA device:
    on the CPU, and without a GPU, FrameSource raises naming the device and
    the ffmpeg conversion. A codec the port does not decode (HEVC: the same
    file under an 'hvc1' entry) raises on every call, naming it."""
    import torch

    path = tmp_path / "cam_0.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    for _ in range(3):
        w.write(np.zeros((48, 64, 3), np.uint8))
    w.release()
    assert read_video_properties(path).frame_count == 3
    calls = [lambda: FrameSource(path, 0, device="cpu")]
    if not torch.cuda.is_available():
        calls.append(lambda: FrameSource(path, 0))
    for call, match in zip(calls, ["decodes only on the CUDA device", "decodes on the CUDA device and none"]):
        with pytest.raises(CalibrationError, match=match) as e:
            call()
        assert "MPEG-4 Part 2" in str(e.value)
        assert "ffmpeg -i" in str(e.value) and "-c:v rawvideo -pix_fmt gray -f mov" in str(e.value)
    hevc = tmp_path / "hevc.mp4"
    hevc.write_bytes(path.read_bytes().replace(b"mp4v", b"hvc1"))
    for call in (lambda: read_video_properties(hevc), lambda: FrameSource(hevc, 0, device="cpu")):
        with pytest.raises(CalibrationError, match="'hvc1' \\(HEVC\\) is compressed") as e:
            call()
        assert "ffmpeg -i" in str(e.value) and "-c:v rawvideo -pix_fmt gray -f mov" in str(e.value)
    with pytest.raises(CalibrationError, match="not found"):
        read_video_properties(tmp_path / "missing.mp4")
    (tmp_path / "junk.mp4").write_bytes(b"\x00" * 64)
    with pytest.raises(CalibrationError, match="moov"):
        read_track(tmp_path / "junk.mp4")


def test_track_table_with_several_chunks(files, tmp_path):
    """A sample table of several chunks (stsc runs) and stored sizes
    (stsz entries) locates each frame: the cv2 file rewritten so."""
    path, frames = files["cv2"]
    data = path.read_bytes()
    t = read_track(path)
    # split the single chunk into chunks of 3, 3, 1 samples with per-sample sizes
    n, size = t.frame_count, t.frame_bytes
    stsc = struct.pack(">II", 0, 2) + struct.pack(">III", 1, 3, 1) + struct.pack(">III", 3, 1, 1)
    stco = struct.pack(">II", 0, 3) + b"".join(struct.pack(">I", int(t.offsets[i])) for i in (0, 3, 6))
    stsz = struct.pack(">III", 0, 0, n) + struct.pack(f">{n}I", *([size] * n))

    def box(kind, body):
        return struct.pack(">I4s", 8 + len(body), kind) + body

    def replace(buf, kind, body):
        at = buf.index(kind) - 4
        old = struct.unpack(">I", buf[at : at + 4])[0]
        return buf[:at] + box(kind, body) + buf[at + old :], len(box(kind, body)) - old

    moov_at = data.index(b"moov") - 4
    moov = data[moov_at:]
    grow = 0
    for kind, body in ((b"stsc", stsc), (b"stco", stco), (b"stsz", stsz)):
        moov, d = replace(moov, kind, body)
        grow += d
    for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):  # the enclosing boxes grow
        at = moov.index(kind) - 4
        moov = moov[:at] + struct.pack(">I", struct.unpack(">I", moov[at : at + 4])[0] + grow) + moov[at + 4 :]
    out = tmp_path / "chunks.mp4"
    out.write_bytes(data[:moov_at] + moov)
    t2 = read_track(out)
    assert np.array_equal(t2.offsets, t.offsets)
    with FrameSource(out, 0, pixel_format=PixelFormat.GRAY) as src:
        assert all(np.array_equal(p.frame, f) for p, f in zip(src, frames))
    assert [np.array_equal(b[:, :, 0], f) for b, f in zip(_cv2_read_all(out), frames)] == [True] * n


@pytest.mark.parametrize("fisheye", [False, True])
@pytest.mark.parametrize("channels", [1, 3])
def test_undistort_frame_within_one_level(fisheye, channels, one_torch_thread):
    K = np.array([[700.0, 0, 330], [0, 690, 235], [0, 0, 1]])
    dist = np.array([0.1, -0.05, 0.01, 0.0, 0.0]) if fisheye else np.array([-0.3, 0.12, 0.001, -0.002, -0.02])
    rng = np.random.default_rng(7 + channels)
    frame = rng.integers(0, 256, (480, 640) if channels == 1 else (480, 640, 3), dtype=np.uint8)
    want = JaxCameraData(0, (640, 480), matrix=K, distortions=dist, fisheye=fisheye).undistort_frame(frame)
    got = CameraData(0, (640, 480), matrix=K, distortions=dist, fisheye=fisheye).undistort_frame(frame, device="cpu")
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.01


def test_from_video_metadata_equal(files):
    videos = {0: files["cv2"][0], 5: files["rgb"][0]}
    got, want = CameraArray.from_video_metadata(videos), JaxCameraArray.from_video_metadata(videos)
    assert sorted(got.cameras) == sorted(want.cameras) == [0, 5]
    for cid in got.cameras:
        assert got.cameras[cid].size == want.cameras[cid].size == (64, 48)
        assert not got.cameras[cid].has_intrinsics


@pytest.mark.cuda
def test_undistort_frame_on_cuda_matches_cpu():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    K = np.array([[700.0, 0, 330], [0, 690, 235], [0, 0, 1]])
    cam = CameraData(0, (640, 480), matrix=K, distortions=np.array([-0.3, 0.12, 0.001, -0.002, -0.02]))
    frame = np.random.default_rng(3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    cpu = cam.undistort_frame(frame, device="cpu")
    card = cam.undistort_frame(frame)  # numpy in, the card by default, numpy out
    on_card = cam.undistort_frame(torch.from_numpy(frame).cuda())
    assert on_card.is_cuda and np.array_equal(on_card.cpu().numpy(), card)
    assert np.abs(card.astype(int) - cpu.astype(int)).max() <= 1
