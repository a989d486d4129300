"""Video in the QuickTime / ISO-BMFF container: the box parser behind
`media.video`'s reader and the writer behind its writers.

The JAX package decodes through OpenCV's FFmpeg; the port imports no video
library (OpenCV is outside its import boundary), so it locates samples with
this module alone and decodes them itself. One video track is read; its
sample entry names the codec:

- ``'raw '`` at depth 40: grey 8-bit, stored with white as 0 (what
  ``cv2.VideoWriter(..., fourcc=0, isColor=False)`` and ``ffmpeg -c:v
  rawvideo -pix_fmt gray -f mov`` write; FFmpeg inverts on both sides, and
  so do `media.video`'s reader and this module's writer);
- ``'raw '`` at depth 24: packed RGB, 3 bytes a pixel;
- ``'24BG'`` at depth 24: packed BGR;
- ``'jpeg'``: MJPEG, one baseline JPEG a sample (QuickTime's entry);
- ``'mp4v'``: the codec is the ``esds`` box's objectTypeIndication, 0x20
  for MPEG-4 Part 2 (its DecoderSpecificInfo is the VOL header, kept as the
  track's extradata) and 0x6C for JPEG (what FFmpeg writes for MJPEG in
  ``.mp4``);
- ``'avc1'`` / ``'avc3'``: H.264, whose ``avcC`` box gives the SPS and PPS
  (kept as Annex B extradata) and the size of each NAL's length prefix.

Samples are located from the sample tables (``stsz``, ``stsc``, ``stco`` /
``co64``) into one byte offset and size a sample. ``stss`` names the sync
samples (without it every sample is one) and ``ctts`` the composition
offsets, from which each sample's display index follows: frames are
numbered in display order. A raw layout is taken from the sample entry's
tag and depth, never guessed; any other entry (HEVC's ``'hvc1'`` /
``'hev1'`` among them) raises `CalibrationError` naming the codec and the
ffmpeg command that converts the file. Edit lists are ignored: every
stored sample is a frame.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path

import numpy as np

from caliscope_tpu_torch.exceptions import CalibrationError

# (sample-entry tag, depth) -> (channels, channel order)
LAYOUTS = {
    (b"raw ", 40): (1, "gray"),
    (b"raw ", 24): (3, "rgb"),
    (b"24BG", 24): (3, "bgr"),
}


# sample-entry tag -> codec, for the entries that name one alone
COMPRESSED_ENTRIES = {b"jpeg": "jpeg", b"avc1": "h264", b"avc3": "h264"}
# esds objectTypeIndication -> codec (ISO/IEC 14496-1 table 5)
MP4V_OBJECT_TYPES = {0x20: "mpeg4", 0x6C: "jpeg"}
CODEC_NAMES = {"raw": "uncompressed", "jpeg": "MJPEG", "mpeg4": "MPEG-4 Part 2", "h264": "H.264"}


def conversion_hint(path) -> str:
    return f"ffmpeg -i {path} -an -c:v rawvideo -pix_fmt gray -f mov {Path(path).name}"


@dataclass(frozen=True)
class Track:
    """One video track's frame geometry and sample table, in decode order.

    channels, order and stride describe a raw track's frames and are 0, ""
    and 0 for a compressed one."""

    width: int
    height: int
    channels: int
    order: str  # "gray" | "rgb" | "bgr"
    stride: int  # bytes a row, padding included
    offsets: np.ndarray  # (n,) int64 file offset of each sample
    timescale: int
    deltas: np.ndarray  # (n,) int64 duration of each sample in timescale units
    codec: str  # "raw" | "jpeg" | "mpeg4" | "h264"
    sizes: np.ndarray  # (n,) int64 bytes of each sample
    sync: np.ndarray  # (n,) bool, True for a sync sample (decodes without the ones before it)
    display: np.ndarray  # (n,) int64 display index (frame number) of each sample
    extradata: bytes = b""  # mpeg4: the VOL header; h264: SPS and PPS as Annex B NALs
    nal_length_size: int = 0  # h264: bytes of each sample NAL's length prefix

    @property
    def frame_count(self) -> int:
        return len(self.offsets)

    @property
    def intra_only(self) -> bool:
        """Every sample decodes on its own, so one can be skipped unread."""
        return bool(self.sync.all())

    @property
    def frame_bytes(self) -> int:
        return self.stride * self.height

    @property
    def fps(self) -> float:
        """timescale / delta for a constant rate, else frames over the track's
        duration (FFmpeg's average rate); 0.0 if the track has no duration."""
        total = int(self.deltas.sum())
        if self.timescale <= 0 or total <= 0:
            return 0.0
        return float(Fraction(self.timescale * len(self.deltas), total))


def _boxes(buf: bytes, start: int, end: int):
    """(type, body start, body end) of each box in buf[start:end]."""
    off = start
    while off + 8 <= end:
        size, kind = struct.unpack(">I4s", buf[off : off + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", buf[off + 8 : off + 16])[0]
            head = 16
        elif size == 0:
            size = end - off
        if size < head or off + size > end:
            raise CalibrationError(f"malformed {kind!r} box at byte {off}")
        yield kind, off + head, off + size
        off += size


def _find_moov(f, path) -> bytes:
    """The moov box's bytes, found by walking the top-level box headers
    (mdat is seeked over, never read)."""
    f.seek(0, 2)
    end = f.tell()
    off = 0
    while off + 8 <= end:
        f.seek(off)
        head = f.read(16)
        size, kind = struct.unpack(">I4s", head[:8])
        n = 8
        if size == 1:
            size = struct.unpack(">Q", head[8:16])[0]
            n = 16
        elif size == 0:
            size = end - off
        if size < n:
            break
        if kind == b"moov":
            f.seek(off)
            return f.read(size)
        off += size
    raise CalibrationError(
        f"{path} is not a QuickTime/ISO-BMFF file with a movie header (moov box); "
        f"the port reads QuickTime and MP4 files (convert with: {conversion_hint(path)})"
    )


def _child(buf: bytes, start: int, end: int, kind: bytes):
    for k, s, e in _boxes(buf, start, end):
        if k == kind:
            return s, e
    return None


def _u32(buf: bytes, at: int, n: int) -> np.ndarray:
    return np.frombuffer(buf, ">u4", count=n, offset=at).astype(np.int64)


def _descriptor(buf: bytes, at: int, end: int):
    """(tag, body start, body end) of the MPEG-4 descriptor at `at`; its size
    is up to four 7-bit groups, the high bit set on all but the last."""
    if at + 2 > end:
        raise CalibrationError("esds descriptor cut short")
    tag, size, at = buf[at], 0, at + 1
    for _ in range(4):
        byte = buf[at]
        at += 1
        size = (size << 7) | (byte & 0x7F)
        if not byte & 0x80:
            break
    if at + size > end:
        raise CalibrationError(f"esds descriptor 0x{tag:02x} overruns its box")
    return tag, at, at + size


def _esds(buf: bytes, s: int, e: int, path) -> tuple[int, bytes]:
    """objectTypeIndication and DecoderSpecificInfo of an esds box."""
    tag, es, ee = _descriptor(buf, s + 4, e)  # past the full box's version and flags
    if tag != 0x03:
        raise CalibrationError(f"{path}: esds holds no ES_Descriptor")
    flags = buf[es + 2]
    at = es + 3 + (2 if flags & 0x80 else 0)
    if flags & 0x40:
        at += 1 + buf[at]
    at += 2 if flags & 0x20 else 0
    tag, ds, de = _descriptor(buf, at, ee)
    if tag != 0x04:
        raise CalibrationError(f"{path}: esds holds no DecoderConfigDescriptor")
    dsi, at = b"", ds + 13
    while at < de:
        tag, bs, be = _descriptor(buf, at, de)
        if tag == 0x05:
            dsi = bytes(buf[bs:be])
        at = be
    return buf[ds], dsi


def _avcc(buf: bytes, s: int, e: int, path) -> tuple[bytes, int]:
    """SPS and PPS as Annex B NALs, and the NAL length size, of an avcC box."""
    if e - s < 7 or buf[s] != 1:
        raise CalibrationError(f"{path}: malformed avcC box")
    length_size = (buf[s + 4] & 3) + 1
    out, at = [], s + 5
    for mask in (0x1F, 0xFF):  # the SPS count is 5 bits, the PPS count 8
        count = buf[at] & mask
        at += 1
        for _ in range(count):
            n = struct.unpack(">H", buf[at : at + 2])[0]
            out.append(b"\x00\x00\x00\x01" + bytes(buf[at + 2 : at + 2 + n]))
            at += 2 + n
    if at > e or not out:
        raise CalibrationError(f"{path}: malformed avcC box")
    return b"".join(out), length_size


def _unsupported(path, tag: bytes, detail: str = "") -> CalibrationError:
    codec = tag.decode("latin-1")
    return CalibrationError(
        f"{path}: video codec '{codec}'{detail} is compressed in a form the port does not decode "
        f"(it decodes MJPEG on the CPU and the CUDA device, MPEG-4 Part 2 and H.264 on the CUDA device, "
        f"and uncompressed 8-bit video anywhere); convert with: {conversion_hint(path)}"
    )


def _sample_entry(buf: bytes, d0: int, path):
    """(codec, channels, order, extradata, NAL length size) of the sample
    entry at d0."""
    tag = buf[d0 + 4 : d0 + 8]
    depth = struct.unpack(">H", buf[d0 + 82 : d0 + 84])[0]
    layout = LAYOUTS.get((tag, depth))
    if layout is not None:
        return "raw", *layout, b"", 0
    if tag in (b"raw ", b"24BG"):
        raise CalibrationError(
            f"{path}: uncompressed '{tag.decode('latin-1')}' video at depth {depth} is not a layout the port reads "
            f"(grey 8-bit 'raw ' depth 40, RGB 'raw ' depth 24, BGR '24BG' depth 24); "
            f"convert with: {conversion_hint(path)}"
        )
    end = d0 + struct.unpack(">I", buf[d0 : d0 + 4])[0]
    children = {k: (a, b) for k, a, b in _boxes(buf, d0 + 86, end)}
    if tag == b"mp4v":
        if b"esds" not in children:
            raise CalibrationError(f"{path}: 'mp4v' sample entry without an esds box")
        oti, dsi = _esds(buf, *children[b"esds"], path)
        if oti not in MP4V_OBJECT_TYPES:
            raise _unsupported(path, tag, f" (objectTypeIndication 0x{oti:02x})")
        return MP4V_OBJECT_TYPES[oti], 0, "", dsi, 0
    if tag in (b"hvc1", b"hev1"):
        raise _unsupported(path, tag, " (HEVC)")
    if tag not in COMPRESSED_ENTRIES:
        raise _unsupported(path, tag)
    codec = COMPRESSED_ENTRIES[tag]
    if codec == "h264":
        if b"avcC" not in children:
            raise CalibrationError(f"{path}: '{tag.decode('latin-1')}' sample entry without an avcC box")
        return codec, 0, "", *_avcc(buf, *children[b"avcC"], path)
    return codec, 0, "", b"", 0


def _parse_video_trak(buf: bytes, s: int, e: int, path) -> Track | None:
    mdia = _child(buf, s, e, b"mdia")
    if mdia is None:
        return None
    hdlr = _child(buf, *mdia, b"hdlr")
    if hdlr is None or buf[hdlr[0] + 8 : hdlr[0] + 12] != b"vide":
        return None
    mdhd = _child(buf, *mdia, b"mdhd")
    minf = _child(buf, *mdia, b"minf")
    stbl = _child(buf, *minf, b"stbl") if minf else None
    if mdhd is None or stbl is None:
        raise CalibrationError(f"{path}: video track without a media header or sample table")
    m0 = mdhd[0]
    timescale = struct.unpack(">I", buf[m0 + 20 : m0 + 24] if buf[m0] == 1 else buf[m0 + 12 : m0 + 16])[0]
    tables = {k: (a, b) for k, a, b in _boxes(buf, *stbl)}
    if b"stsd" not in tables:
        raise CalibrationError(f"{path}: video track without a sample description")
    d0 = tables[b"stsd"][0] + 8  # first sample entry
    width, height = struct.unpack(">HH", buf[d0 + 32 : d0 + 36])
    codec, channels, order, extradata, nal_length_size = _sample_entry(buf, d0, path)
    if not all(k in tables for k in (b"stsz", b"stsc", b"stts")) or not (b"stco" in tables or b"co64" in tables):
        raise CalibrationError(f"{path}: incomplete sample table (a fragmented file?)")

    z0 = tables[b"stsz"][0]
    sample_size, n = struct.unpack(">II", buf[z0 + 4 : z0 + 12])
    sizes = np.full(n, sample_size, np.int64) if sample_size else _u32(buf, z0 + 12, n)
    if n == 0:
        raise CalibrationError(f"{path}: the video track holds no frames")
    if b"co64" in tables:
        c0 = tables[b"co64"][0]
        n_chunks = struct.unpack(">I", buf[c0 + 4 : c0 + 8])[0]
        chunk_offsets = np.frombuffer(buf, ">u8", count=n_chunks, offset=c0 + 8).astype(np.int64)
    else:
        c0 = tables[b"stco"][0]
        n_chunks = struct.unpack(">I", buf[c0 + 4 : c0 + 8])[0]
        chunk_offsets = _u32(buf, c0 + 8, n_chunks)
    s0 = tables[b"stsc"][0]
    n_runs = struct.unpack(">I", buf[s0 + 4 : s0 + 8])[0]
    runs = _u32(buf, s0 + 8, 3 * n_runs).reshape(n_runs, 3)
    # samples a chunk: each run of stsc covers chunks first..next first - 1
    firsts = np.append(runs[:, 0], n_chunks + 1)
    per_chunk = np.repeat(runs[:, 1], np.diff(firsts))
    if per_chunk.sum() < n:
        raise CalibrationError(f"{path}: the chunk table covers fewer samples than the size table")
    chunk_of = np.repeat(np.arange(n_chunks), per_chunk)[:n]
    ends = np.cumsum(sizes)
    chunk_start = np.concatenate([[0], np.cumsum(per_chunk)])[chunk_of]
    before = ends - sizes - np.concatenate([[0], ends])[chunk_start]
    offsets = chunk_offsets[chunk_of] + before

    t0 = tables[b"stts"][0]
    n_tts = struct.unpack(">I", buf[t0 + 4 : t0 + 8])[0]
    tts = _u32(buf, t0 + 8, 2 * n_tts).reshape(n_tts, 2)
    deltas = np.repeat(tts[:, 1], tts[:, 0])[:n]
    if len(deltas) < n:
        deltas = np.concatenate([deltas, np.zeros(n - len(deltas), np.int64)])

    sync = np.ones(n, bool)
    if b"stss" in tables:
        k0 = tables[b"stss"][0]
        numbers = _u32(buf, k0 + 8, struct.unpack(">I", buf[k0 + 4 : k0 + 8])[0])
        if len(numbers) == 0 or numbers.min() < 1 or numbers.max() > n:
            raise CalibrationError(f"{path}: the sync sample table names samples the track does not hold")
        sync[:] = False
        sync[numbers - 1] = True
    display = np.arange(n, dtype=np.int64)
    if b"ctts" in tables:
        o0 = tables[b"ctts"][0]
        n_ctts = struct.unpack(">I", buf[o0 + 4 : o0 + 8])[0]
        pairs = np.frombuffer(buf, ">i4" if buf[o0] == 1 else ">u4", count=2 * n_ctts, offset=o0 + 8)
        pairs = pairs.astype(np.int64).reshape(n_ctts, 2)
        shift = np.repeat(pairs[:, 1], pairs[:, 0])[:n]
        shift = np.concatenate([shift, np.zeros(n - len(shift), np.int64)])
        order_shown = np.argsort(np.cumsum(deltas) - deltas + shift, kind="stable")
        display[order_shown] = np.arange(n)

    if height == 0 or width == 0:
        raise CalibrationError(f"{path}: the sample entry gives frames of {width}x{height}")
    stride = 0
    if codec == "raw":
        if np.any(sizes != sizes[0]) or sizes[0] % height:
            raise CalibrationError(f"{path}: frames of {width}x{height} do not match the stored sample sizes")
        stride = int(sizes[0]) // height
        if stride < width * channels:
            raise CalibrationError(f"{path}: {sizes[0]} bytes a sample are too few for {width}x{height} {order}")
    return Track(width, height, channels, order, stride, offsets, int(timescale), deltas,
                 codec, sizes, sync, display, extradata, nal_length_size)


def read_track(path) -> Track:
    """The first video track of the file at `path`."""
    path = Path(path)
    if not path.exists():
        raise CalibrationError(f"Video file not found: {path}")
    with open(path, "rb") as f:
        moov = _find_moov(f, path)
    for kind, s, e in _boxes(moov, 8, len(moov)):
        if kind == b"trak":
            track = _parse_video_trak(moov, s, e, path)
            if track is not None:
                return track
    raise CalibrationError(f"{path} holds no video track")


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def movie_box(width: int, height: int, timescale: int, delta: int, n: int, entry: bytes, stsz: bytes,
              data_at: int, stss: bytes = b"") -> bytes:
    """The moov box of one video track of `n` samples at a constant rate,
    stored as one chunk at file offset `data_at`: `entry` is the sample
    entry, `stsz` the size table and `stss` the sync table (none: every
    sample is a sync sample)."""
    media_duration = n * delta
    movie_duration = round(media_duration * 1000 / timescale)
    unity = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    mvhd = _box(b"mvhd", struct.pack(">IIIII", 0, 0, 0, 1000, movie_duration),
                struct.pack(">IH10x", 0x10000, 0x100), unity, bytes(24), struct.pack(">I", 2))
    tkhd = _box(b"tkhd", struct.pack(">IIIIII", 3, 0, 0, 1, 0, movie_duration), bytes(8),
                struct.pack(">HHHH", 0, 0, 0, 0), unity,
                struct.pack(">II", width << 16, height << 16))
    elst = _box(b"edts", _box(b"elst", struct.pack(">IIIII", 0, 1, movie_duration, 0, 0x10000)))
    mdhd = _box(b"mdhd", struct.pack(">IIIIIHH", 0, 0, 0, timescale, media_duration, 0x7FFF, 0))
    hdlr = _box(b"hdlr", struct.pack(">I4s4s", 0, b"mhlr", b"vide"), bytes(12), b"\x0cVideoHandler")
    chunk = (_box(b"stco", struct.pack(">III", 0, 1, data_at)) if data_at < 2**32
             else _box(b"co64", struct.pack(">IIQ", 0, 1, data_at)))
    stbl = _box(
        b"stbl",
        _box(b"stsd", struct.pack(">II", 0, 1), entry),
        _box(b"stts", struct.pack(">IIII", 0, 1, n, delta)),
        stss,
        _box(b"stsc", struct.pack(">IIIII", 0, 1, 1, n, 1)),
        stsz,
        chunk,
    )
    minf = _box(
        b"minf",
        _box(b"vmhd", struct.pack(">I", 1), bytes(8)),
        _box(b"hdlr", struct.pack(">I4s4s", 0, b"dhlr", b"url "), bytes(12), b"\x0bDataHandler"),
        _box(b"dinf", _box(b"dref", struct.pack(">II", 0, 1), _box(b"url ", struct.pack(">I", 1)))),
        stbl,
    )
    return _box(b"moov", mvhd, _box(b"trak", tkhd, elst, _box(b"mdia", mdhd, hdlr, minf)))


class MovieWriter:
    """One video track written sample by sample into one ``mdat``, which
    follows a ``wide`` placeholder and becomes a 64-bit ``mdat`` header past
    4 GiB; the movie header is written by `close`. A subclass gives the
    sample entry (`_entry`) and calls `_write_sample`."""

    def __init__(self, path, size: tuple[int, int], fps: float, brand: bytes):
        self.path = Path(path)
        self.width, self.height = (int(v) for v in size)
        rate = Fraction(fps).limit_denominator(100_000)
        if rate <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        self.timescale, self.delta = rate.numerator, rate.denominator
        self.count = 0
        self._sizes: list[int] = []
        self._sync: list[bool] = []
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(_box(b"ftyp", brand, struct.pack(">I", 0x200), brand))
        self._mdat_at = self._f.tell()
        self._f.write(_box(b"wide") + struct.pack(">I4s", 8, b"mdat"))
        self._data_at = self._f.tell()

    def _entry(self) -> bytes:
        raise NotImplementedError

    def _write_sample(self, data: bytes, sync: bool = True) -> None:
        self._f.write(data)
        self._sizes.append(len(data))
        self._sync.append(sync)
        self.count += 1

    def _moov(self) -> bytes:
        n = self.count
        if len(set(self._sizes)) == 1:
            stsz = _box(b"stsz", struct.pack(">III", 0, self._sizes[0], n))
        else:
            stsz = _box(b"stsz", struct.pack(f">III{n}I", 0, 0, n, *self._sizes))
        stss = b""
        if not all(self._sync):
            numbers = [i + 1 for i, s in enumerate(self._sync) if s]
            stss = _box(b"stss", struct.pack(f">II{len(numbers)}I", 0, len(numbers), *numbers))
        return movie_box(self.width, self.height, self.timescale, self.delta, n, self._entry(), stsz,
                         self._data_at, stss)

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            mdat_size = 8 + sum(self._sizes)
            if self.count == 0:
                raise CalibrationError(f"no frames were written to {self.path}")
            self._f.write(self._moov())
            self._f.seek(self._mdat_at)
            if mdat_size < 2**32:
                self._f.write(_box(b"wide") + struct.pack(">I4s", mdat_size, b"mdat"))
            else:  # the wide placeholder's 8 bytes become the 64-bit size
                self._f.write(struct.pack(">I4sQ", 1, b"mdat", mdat_size + 8))
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def visual_entry(tag: bytes, width: int, height: int, depth: int, *children: bytes) -> bytes:
    """A visual sample entry (ISO/IEC 14496-12 8.5.2) with its child boxes."""
    return _box(
        tag, bytes(6), struct.pack(">H", 1), struct.pack(">HH4sII", 0, 0, b"FFMP", 0, 0x400),
        struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
        struct.pack(">Hh", depth, -1), *children,
    )


class RawQuickTimeWriter(MovieWriter):
    """Writes frames as uncompressed QuickTime: grey 8-bit (``'raw '``
    depth 40) or packed RGB (``'raw '`` depth 24), rows unpadded."""

    def __init__(self, path, size: tuple[int, int], fps: float, order: str = "gray"):
        if order not in ("gray", "rgb"):
            raise ValueError(f"order must be 'gray' or 'rgb', got {order!r}")
        super().__init__(path, size, fps, b"qt  ")
        self.channels = 1 if order == "gray" else 3
        self.order = order

    def write(self, frame: np.ndarray) -> None:
        shape = (self.height, self.width) if self.channels == 1 else (self.height, self.width, 3)
        frame = np.asarray(frame)
        if frame.shape != shape or frame.dtype != np.uint8:
            raise ValueError(f"expected a {shape} uint8 frame, got {frame.shape} {frame.dtype}")
        if self.channels == 1:
            frame = np.invert(frame)  # white is 0 in QuickTime's 8-bit grey
        self._write_sample(np.ascontiguousarray(frame).tobytes())

    def _entry(self) -> bytes:
        return visual_entry(b"raw ", self.width, self.height, 40 if self.channels == 1 else 24)
