"""Compressed video in the port (caliscope_tpu_torch/media/) held against
the JAX package's FrameSource, which decodes through OpenCV's FFmpeg, on
the same files:

- the numpy JPEG decoder (media/jpeg.py): each plane equal to libjpeg's
  (cv2.imdecode, grey) at 4:4:4, 4:2:2, 4:2:0, with restart intervals and
  on single-component images; progressive, arithmetic and 12-bit JPEG
  raise;
- FrameSource(device="cpu") on MJPEG in .mov ('jpeg') and .mp4 ('mp4v'
  whose esds says JPEG), GRAY and BGR, with and without wanted_indices:
  the same indices, and frames within MAX_GREY_LEVELS (grey) and
  MAX_BGR_LEVELS (BGR) of the JAX package's; the largest differences met
  are stated beside the bounds;
- read_video_properties equal to the JAX package's on mp4v, MJPEG and the
  port's H.264 and MJPEG writers' clips;
- the container's esds / avcC / stss / ctts parsing, and the samples a
  decode of the wanted frames needs across sync samples; FrameSource's
  NVDEC path driven through a stand-in decoder (which samples it feeds,
  the late display and the flush), and the NVDEC structures' offsets;
- device="cpu" raising for mp4v and H.264, and the YUV conversion;
- `cuda`-marked twins of tests/test_media.py's TestFrameSource on mp4v
  (NVDEC) and the nvJPEG decode against the numpy one, which skip here.

The clips are made here with OpenCV, at most 160 x 120 and 8 frames.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from caliscope_tpu.media import FrameSource as JaxFrameSource
from caliscope_tpu.media import read_video_properties as jax_props
from caliscope_tpu.packets import PixelFormat as JaxPixelFormat

from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.media import FrameSource, jpeg, read_video_properties
from caliscope_tpu_torch.media.colour import yuv_to_bgr, yuv_to_frame
from caliscope_tpu_torch.media.h264_pcm import H264PcmWriter, luma_from_gray
from caliscope_tpu_torch.media.mjpeg_writer import MjpegWriter, encode_gray
from caliscope_tpu_torch.media.quicktime import read_track
from caliscope_tpu_torch.media.video import _needed_samples
from caliscope_tpu_torch.packets import PixelFormat
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

W, H, N = 160, 120, 8
# the gate on grey frames (swscale's fixed-point YUV -> BGR against the
# port's float BT.601, and FFmpeg's IDCT against libjpeg's islow): the
# largest difference these clips give is 2, on grey and colour content
MAX_GREY_LEVELS = 2
# BGR channels, where chroma rounding adds to it: the largest difference
# these clips give is 2 on grey content and 4 on colour
MAX_BGR_LEVELS = 4


def _frames(colour: bool) -> list[np.ndarray]:
    """Smooth in-gamut BGR content that moves: colour gradients with a
    dark square, or a grey checkerboard with a bright disc."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = []
    for i in range(N):
        if colour:
            b = 60 + 120 * xx / W
            g = 40 + 150 * (yy / H) ** 1.5
            r = 200 - 100 * np.abs(np.sin((xx + 7 * i) / 25))
            img = np.stack([b, g, r], axis=-1)
            img[30 + i : 60 + i, 40 + 3 * i : 70 + 3 * i] *= 0.3
        else:
            board = ((xx + 2 * i) // 20 + yy // 20) % 2
            img = 40 + 170 * board
            img[(xx - 80 - i) ** 2 + (yy - 60) ** 2 < 300] = 235
            img = np.repeat(img[..., None], 3, axis=-1)
        out.append(cv2.GaussianBlur(np.clip(img, 0, 255).astype(np.uint8), (5, 5), 1.0))
    return out


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """OpenCV's MJPEG in .mov and .mp4 and its mp4v, of grey and colour
    content; the port's H.264 (limited and full range) and MJPEG clips."""
    d = tmp_path_factory.mktemp("decode")
    out = {}
    for colour in (False, True):
        frames = _frames(colour)
        for name, fourcc in (("mjpeg.mov", "MJPG"), ("mjpeg.mp4", "MJPG"), ("mp4v.mp4", "mp4v")):
            path = d / f"{'colour' if colour else 'grey'}_{name}"
            w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30.0, (W, H))
            for f in frames:
                w.write(f)
            w.release()
            out[path.name] = path
    luma = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _frames(False)]
    luma[3] = luma[2]  # an unchanged frame: a P slice of skips alone
    for full in (False, True):
        path = d / f"pcm_{'full' if full else 'limited'}.mp4"
        with H264PcmWriter(path, (W, H), 25.0, gop=3, full_range=full) as w:
            for f in luma:
                w.write(luma_from_gray(f, full))
        out[path.name] = path
    with MjpegWriter(d / "port_mjpeg.mov", (W, H), 24.0, quality=100) as w:
        for f in luma:
            w.write(f)
    out["port_mjpeg.mov"] = d / "port_mjpeg.mov"
    out["luma"] = luma
    return out


def _read(cls, path, fmt, wanted=None, **kw):
    with cls(path, 1, pixel_format=fmt, wanted_indices=wanted, **kw) as src:
        return [(p.frame_index, p.frame) for p in src]


# ---- the numpy JPEG decoder ---------------------------------------------------


@pytest.mark.parametrize("sampling", [0x111111, 0x211111, 0x221111])
@pytest.mark.parametrize("restart", [0, 2])
def test_jpeg_planes_equal_libjpeg(sampling, restart):
    img = _frames(True)[5]
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    got = jpeg.decode(buf.tobytes())
    hs = {0x111111: (1, 1), 0x211111: (2, 1), 0x221111: (2, 2)}[sampling]
    assert (got.width, got.height) == (W, H) and len(got.planes) == 3
    assert got.planes[1].shape == (-(-H // hs[1]), -(-W // hs[0])) == got.planes[2].shape
    assert np.array_equal(got.planes[0], cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def test_jpeg_single_component_and_refusals():
    grey = cv2.cvtColor(_frames(False)[0], cv2.COLOR_BGR2GRAY)[:117, :151]
    ok, buf = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, 70])
    got = jpeg.decode(buf.tobytes())
    assert len(got.planes) == 1 and np.array_equal(got.planes[0], cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    ok, prog = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(CalibrationError, match="progressive"):
        jpeg.decode(prog.tobytes())
    data = buf.tobytes()
    sof = data.index(b"\xff\xc0")
    with pytest.raises(CalibrationError, match="arithmetic"):
        jpeg.decode(data[:sof] + b"\xff\xc9" + data[sof + 2 :])
    with pytest.raises(CalibrationError, match="12-bit"):
        jpeg.decode(data[: sof + 4] + bytes([12]) + data[sof + 5 :])
    with pytest.raises(CalibrationError, match="SOI"):
        jpeg.decode(b"\x00" + data)


def test_encoder_round_trip(one_torch_thread):
    """The port's grey JPEG encoder: libjpeg and the numpy decoder read the
    same planes; at quality 100 within one level of the frame."""
    frame = cv2.cvtColor(_frames(False)[4], cv2.COLOR_BGR2GRAY)[:, :150]
    for q in (100, 75):
        data = encode_gray(frame, q)
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
        assert np.array_equal(jpeg.decode(data).planes[0], ref)
        if q == 100:
            assert np.abs(ref.astype(int) - frame).max() <= 1


# ---- FrameSource on the CPU against the JAX package ---------------------------


@pytest.mark.parametrize("name", ["grey_mjpeg.mov", "grey_mjpeg.mp4", "colour_mjpeg.mov", "colour_mjpeg.mp4"])
@pytest.mark.parametrize("fmt", ["GRAY", "BGR"])
@pytest.mark.parametrize("wanted", [None, {1, 4, 6}])
def test_mjpeg_on_the_cpu_against_the_jax_decode(clips, name, fmt, wanted, one_torch_thread):
    want = _read(JaxFrameSource, clips[name], JaxPixelFormat[fmt], wanted)
    got = _read(FrameSource, clips[name], PixelFormat[fmt], wanted, device="cpu")
    assert [i for i, _ in got] == [i for i, _ in want] == (sorted(wanted) if wanted else list(range(N)))
    worst = max(int(np.abs(g.astype(int) - w.astype(int)).max()) for (_, g), (_, w) in zip(got, want))
    assert all(g.shape == w.shape and g.dtype == np.uint8 for (_, g), (_, w) in zip(got, want))
    assert worst <= (MAX_GREY_LEVELS if fmt == "GRAY" else MAX_BGR_LEVELS), worst


def test_port_mjpeg_writer_read_by_both(clips, one_torch_thread):
    """The port's MJPEG writer: OpenCV's FFmpeg and the port read every
    frame within one grey level of the frame written (quality 100)."""
    path, luma = clips["port_mjpeg.mov"], clips["luma"]
    want = _read(JaxFrameSource, path, JaxPixelFormat.GRAY)
    got = _read(FrameSource, path, PixelFormat.GRAY, device="cpu")
    assert len(got) == len(want) == N
    for (_, g), (_, w), f in zip(got, want, luma):
        assert np.abs(g.astype(int) - f).max() <= 1 and np.abs(w.astype(int) - f).max() <= 1


@pytest.mark.parametrize("name", ["grey_mp4v.mp4", "colour_mjpeg.mov", "grey_mjpeg.mp4", "pcm_limited.mp4",
                                  "pcm_full.mp4", "port_mjpeg.mov"])
def test_read_video_properties_equal(clips, name):
    got, want = read_video_properties(clips[name]), jax_props(clips[name])
    assert (got.width, got.height, got.frame_count) == (want.width, want.height, want.frame_count) == (W, H, N)
    assert got.fps == pytest.approx(want.fps, rel=1e-9)


@pytest.mark.parametrize("name", ["grey_mp4v.mp4", "pcm_limited.mp4"])
def test_cpu_refuses_nvdec_codecs(clips, name):
    codec = "MPEG-4 Part 2" if "mp4v" in name else "H.264"
    with pytest.raises(CalibrationError, match=f"{codec} video decodes only on the CUDA device"):
        FrameSource(clips[name], 0, device="cpu")


# ---- the H.264 writer's clips through OpenCV -----------------------------------


@pytest.mark.parametrize("full", [False, True])
def test_pcm_clips_read_by_the_jax_frame_source(clips, full):
    """Every frame within one grey level of the written luma's conversion
    (limited range: (Y - 16) * 255 / 219), exact at full range."""
    luma = clips["luma"]
    path = clips[f"pcm_{'full' if full else 'limited'}.mp4"]
    got = _read(JaxFrameSource, path, JaxPixelFormat.GRAY)
    assert [i for i, _ in got] == list(range(N))
    assert jax_props(path).fps == 25.0
    for (_, g), f in zip(got, luma):
        y = luma_from_gray(f, full).astype(np.float64)
        want = y if full else (y - 16) * 255 / 219
        assert np.abs(g - want).max() <= (0 if full else 1)


# ---- the container --------------------------------------------------------------


def _insert_box(path, out, parent: bytes, box: bytes):
    """`path` rewritten with `box` appended to its `parent` box (inside the
    moov, which is last); the enclosing boxes grow."""
    data = path.read_bytes()
    moov_at = data.index(b"moov") - 4
    moov = bytearray(data[moov_at:])
    chain = [b"moov", b"trak", b"mdia", b"minf", b"stbl"]
    chain = chain[: chain.index(parent) + 1]
    at = [moov.index(kind) - 4 for kind in chain]
    end = at[-1] + struct.unpack(">I", moov[at[-1] : at[-1] + 4])[0]
    moov[end:end] = box
    for a in at:
        size = struct.unpack(">I", moov[a : a + 4])[0]
        moov[a : a + 4] = struct.pack(">I", size + len(box))
    out.write_bytes(data[:moov_at] + bytes(moov))


def test_esds_avcc_stss_and_ctts(clips, tmp_path):
    t = read_track(clips["grey_mp4v.mp4"])
    assert t.codec == "mpeg4" and t.extradata.startswith(b"\x00\x00\x01\xb0") and t.sync[0]
    assert (t.channels, t.stride, t.frame_count) == (0, 0, N)
    t = read_track(clips["grey_mjpeg.mp4"])
    assert t.codec == "jpeg" and t.extradata == b"" and t.intra_only  # 'mp4v' entry, esds JPEG (0x6C)
    t = read_track(clips["grey_mjpeg.mov"])
    assert t.codec == "jpeg" and t.intra_only
    path = clips["pcm_limited.mp4"]
    t = read_track(path)
    assert t.codec == "h264" and t.nal_length_size == 4
    w = H264PcmWriter(tmp_path / "x.mp4", (W, H), 25.0)
    w._f.close()
    assert t.extradata == b"\x00\x00\x00\x01" + w.sps + b"\x00\x00\x00\x01" + w.pps
    assert t.sync.tolist() == [i % 3 == 0 for i in range(N)] and not t.intra_only
    assert np.array_equal(t.display, np.arange(N))
    # composition offsets that show decode order 0 2 1 3 4 ... as frames 0 1 2 ...
    offsets = [0, 2, 0] + [1] * (N - 3)
    ctts = struct.pack(f">II{2 * N}I", 0, N, *[v for o in offsets for v in (1, o)])
    out = tmp_path / "ctts.mp4"
    _insert_box(path, out, b"stbl", struct.pack(">I4s", 8 + len(ctts), b"ctts") + ctts)
    t2 = read_track(out)
    assert np.array_equal(t2.offsets, t.offsets)
    assert t2.display.tolist() == [0, 2, 1] + list(range(3, N))


def test_samples_needed_across_sync_samples(clips, tmp_path):
    t = read_track(clips["pcm_limited.mp4"])  # sync at 0, 3, 6
    assert _needed_samples(t, None).all()
    assert np.flatnonzero(_needed_samples(t, {5})).tolist() == [3, 4, 5]
    assert np.flatnonzero(_needed_samples(t, {1, 7})).tolist() == [0, 1, 6, 7]
    assert np.flatnonzero(_needed_samples(t, {3, 99})).tolist() == [3]
    mj = read_track(clips["grey_mjpeg.mov"])
    assert np.flatnonzero(_needed_samples(mj, {2, 5})).tolist() == [2, 5]


class _FakeNvdec:
    """NVDEC's part of FrameSource played on the CPU: it records the samples
    fed, shows each picture one sample late (as a parser with a display
    delay does) and flushes at the end; a shown picture is the written
    luma with 128 chroma, taken from the clip's writer-side frames."""

    def __init__(self, luma, log):
        self.luma, self.log, self.frames, self.full_range, self._held = luma, log, {}, False, None

    def __call__(self, codec, extradata, size, device, *, nal_length_size=0, wanted=None):
        self.wanted = wanted
        return self

    def _show(self, index):
        if self.wanted is None or index in self.wanted:
            y = torch.from_numpy(self.luma[index])
            self.frames[index] = (y, torch.full((H // 2, W // 2, 2), 128, dtype=torch.uint8))

    def feed(self, sample, index):
        self.log.append(index)
        if self._held is not None:
            self._show(self._held)
        self._held = index

    def end(self):
        self.log.append("end")
        if self._held is not None:
            self._show(self._held)
        self._held = None

    def pop(self, index):
        return self.frames.pop(index, None)

    def close(self):
        pass


@pytest.mark.parametrize("wanted, fed", [
    (None, list(range(N)) + ["end"]),
    ({5}, [3, 4, 5, "end"]),  # from the sync sample before it
    ({1, 7}, [0, 1, 6, 7, "end"]),
])
def test_frame_source_feeds_nvdec_from_the_sync_sample(clips, monkeypatch, wanted, fed):
    """FrameSource's NVDEC path, which no CPU can run, with a stand-in
    decoder: the samples it feeds for the wanted frames (sync samples at 0,
    3, 6), the frames in order after a late display and the flush, and the
    limited-range conversion of the luma."""
    from caliscope_tpu_torch.media import nvdec

    luma = [luma_from_gray(f, False) for f in clips["luma"]]
    log = []
    monkeypatch.setattr(nvdec, "NvdecDecoder", _FakeNvdec(luma, log))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = _read(FrameSource, clips["pcm_limited.mp4"], PixelFormat.GRAY, wanted, device="cuda")
    assert log == fed
    assert [i for i, _ in got] == (sorted(wanted) if wanted else list(range(N)))
    for i, frame in got:
        want = (luma[i].astype(np.float64) - 16) * 255 / 219
        assert np.abs(frame - want).max() <= 1


def test_yuv_conversion():
    """Full range: grey is Y; limited range: (Y - 16) * 255 / 219; colour
    as BT.601 rounds it; nearest chroma."""
    y = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    c = torch.full((8, 8), 128, dtype=torch.uint8)
    assert torch.equal(yuv_to_frame(y, c, c, True, True), y)
    lim = yuv_to_frame(y, c, c, False, True).int()
    want = ((y.double() - 16) * 255 / 219).round().clamp(0, 255).int()
    assert (lim - want).abs().max() <= 1
    bgr = yuv_to_bgr(torch.tensor([[128, 128]], dtype=torch.uint8), torch.tensor([[200]], dtype=torch.uint8),
                     torch.tensor([[60]], dtype=torch.uint8), True)
    assert bgr.shape == (1, 2, 3) and torch.equal(bgr[0, 0], bgr[0, 1])
    b, g, r = (128 + 1.772 * 72, 128 - 0.344136 * 72 + 0.714136 * 68, 128 - 1.402 * 68)
    assert bgr[0, 0].tolist() == [min(255, round(b)), round(g), round(r)]


def test_nvdec_layouts_and_annex_b():
    """The hand-declared NVDEC structures at the SDK headers' offsets
    (x86-64; the parser's CUVIDEOFORMAT was read on an H100's driver at these
    offsets), and MP4 samples rewritten as Annex B."""
    import ctypes

    from caliscope_tpu_torch.media import nvdec

    def at(struct_, field):
        return getattr(struct_, field).offset

    assert ctypes.sizeof(nvdec.CUVIDEOFORMAT) == 64
    assert (at(nvdec.CUVIDEOFORMAT, "coded_width"), at(nvdec.CUVIDEOFORMAT, "display_area"),
            at(nvdec.CUVIDEOFORMAT, "chroma_format"), at(nvdec.CUVIDEOFORMAT, "video_signal_description")) == (16, 24, 40, 56)
    assert (at(nvdec.CUVIDPARSERPARAMS, "pUserData"), at(nvdec.CUVIDPARSERPARAMS, "pfnSequenceCallback"),
            at(nvdec.CUVIDPARSERPARAMS, "pfnDisplayPicture"), at(nvdec.CUVIDPARSERPARAMS, "pExtVideoInfo")) == (40, 48, 64, 128)
    assert (at(nvdec.CUVIDDECODECREATEINFO, "CodecType"), at(nvdec.CUVIDDECODECREATEINFO, "display_area"),
            at(nvdec.CUVIDDECODECREATEINFO, "OutputFormat"), at(nvdec.CUVIDDECODECREATEINFO, "vidLock"),
            at(nvdec.CUVIDDECODECREATEINFO, "Reserved2")) == (24, 80, 88, 120, 144)
    assert (at(nvdec.CUVIDPROCPARAMS, "raw_input_dptr"), at(nvdec.CUVIDPROCPARAMS, "output_stream"),
            at(nvdec.CUVIDPROCPARAMS, "histogram_dptr")) == (24, 56, 248)
    assert (at(nvdec.CUVIDDECODECAPS, "bIsSupported"), at(nvdec.CUVIDDECODECAPS, "nMaxWidth"),
            at(nvdec.CUVIDDECODECAPS, "nMinWidth")) == (24, 28, 40)
    assert at(nvdec.CUVIDPARSERDISPINFO, "timestamp") == 16 and at(nvdec.CUVIDSOURCEDATAPACKET, "timestamp") == 24
    nals = [b"\x67\x42\x00", b"\x65" + bytes(300)]
    sample = b"".join(len(n).to_bytes(4, "big") + n for n in nals)
    assert nvdec.annex_b(sample, 4) == b"".join(b"\x00\x00\x00\x01" + n for n in nals)
    with pytest.raises(CalibrationError, match="runs past"):
        nvdec.annex_b(sample[:-1], 4)


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nvjpeg_against_the_numpy_decoder(clips, cuda_device):
    for name in ("colour_mjpeg.mov", "grey_mjpeg.mp4", "port_mjpeg.mov"):
        for fmt in ("GRAY", "BGR"):
            card = _read(FrameSource, clips[name], PixelFormat[fmt])
            cpu = _read(FrameSource, clips[name], PixelFormat[fmt], device="cpu")
            assert [i for i, _ in card] == [i for i, _ in cpu] == list(range(N))
            assert max(int(np.abs(a.astype(int) - b).max()) for (_, a), (_, b) in zip(card, cpu)) <= MAX_GREY_LEVELS


class TestFrameSourceOnTheCard:
    """tests/test_media.py's TestFrameSource on the port, mp4v through
    NVDEC. Where the card's NVDEC refuses MPEG-4 Part 2 (cuvidGetDecoderCaps),
    FrameSource must raise CalibrationError carrying that answer instead."""

    @pytest.fixture
    def video(self, tmp_path, cuda_device):
        from caliscope_tpu_torch.media.nvdec import decoder_caps

        path = tmp_path / "test.mp4"
        w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
        for i in range(10):
            w.write(np.full((48, 64, 3), i * 20, np.uint8))
        w.release()
        caps = decoder_caps("mpeg4")
        if not caps["supported"]:
            with pytest.raises(CalibrationError, match="refuses mpeg4") as e:
                FrameSource(path, cam_id=3)
            assert str(caps.get("error", "")) in str(e.value)
            pytest.skip(f"the card's NVDEC refuses MPEG-4 Part 2 ({caps}); FrameSource raised as it should")
        return path

    @pytest.mark.cuda
    def test_reads_all_frames(self, video):
        props = read_video_properties(video)
        assert props.size == (64, 48) and props.frame_count == 10
        with FrameSource(video, cam_id=3) as src:
            packets = list(src)
        assert [p.frame_index for p in packets] == list(range(10))
        assert all(p.cam_id == 3 for p in packets)
        assert abs(int(packets[5].frame.mean()) - 100) < 12

    @pytest.mark.cuda
    def test_wanted_indices_skip(self, video):
        with FrameSource(video, cam_id=0, wanted_indices={2, 5, 7}) as src:
            assert [p.frame_index for p in src] == [2, 5, 7]

    @pytest.mark.cuda
    def test_gray_pixel_format(self, video):
        with FrameSource(video, cam_id=0, pixel_format=PixelFormat.GRAY) as src:
            pkt = src.next_frame()
        assert pkt.frame.ndim == 2 and pkt.pixel_format is PixelFormat.GRAY
