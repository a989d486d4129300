"""Uncompressed 8-bit video in the QuickTime / ISO-BMFF container: the
box parser behind `media.video`'s reader and the writer behind its writers.

The JAX package decodes through OpenCV's FFmpeg; the port imports no video
library (OpenCV is outside its import boundary), so it reads, with this
module alone, the recordings that need no codec library: one video track
whose sample entry names an uncompressed layout,

- ``'raw '`` at depth 40: grey 8-bit, stored with white as 0 (what
  ``cv2.VideoWriter(..., fourcc=0, isColor=False)`` and ``ffmpeg -c:v
  rawvideo -pix_fmt gray -f mov`` write; FFmpeg inverts on both sides, and
  so do `media.video`'s reader and this module's writer);
- ``'raw '`` at depth 24: packed RGB, 3 bytes a pixel;
- ``'24BG'`` at depth 24: packed BGR.

Samples are located from the sample tables (``stsz``, ``stsc``, ``stco`` /
``co64``) into one byte offset a frame; a frame is then a read of
``height x stride`` bytes. The layout is taken from the sample entry's tag
and depth, never guessed; any other entry (``mp4v``, ``avc1``, ...) raises
`CalibrationError` naming the codec and the ffmpeg command that converts
the file. Edit lists are ignored: every stored sample is a frame.
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


def conversion_hint(path) -> str:
    return f"ffmpeg -i {path} -an -c:v rawvideo -pix_fmt gray -f mov {Path(path).name}"


@dataclass(frozen=True)
class Track:
    """One video track's frame geometry and sample table."""

    width: int
    height: int
    channels: int
    order: str  # "gray" | "rgb" | "bgr"
    stride: int  # bytes a row, padding included
    offsets: np.ndarray  # (n,) int64 file offset of each frame
    timescale: int
    deltas: np.ndarray  # (n,) int64 duration of each frame in timescale units

    @property
    def frame_count(self) -> int:
        return len(self.offsets)

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
        f"the port reads uncompressed QuickTime video (convert with: {conversion_hint(path)})"
    )


def _child(buf: bytes, start: int, end: int, kind: bytes):
    for k, s, e in _boxes(buf, start, end):
        if k == kind:
            return s, e
    return None


def _u32(buf: bytes, at: int, n: int) -> np.ndarray:
    return np.frombuffer(buf, ">u4", count=n, offset=at).astype(np.int64)


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
    tag = buf[d0 + 4 : d0 + 8]
    width, height = struct.unpack(">HH", buf[d0 + 32 : d0 + 36])
    depth = struct.unpack(">H", buf[d0 + 82 : d0 + 84])[0]
    layout = LAYOUTS.get((tag, depth))
    if layout is None:
        codec = tag.decode("latin-1")
        if tag in (b"raw ", b"24BG"):
            raise CalibrationError(
                f"{path}: uncompressed '{codec}' video at depth {depth} is not a layout the port reads "
                f"(grey 8-bit 'raw ' depth 40, RGB 'raw ' depth 24, BGR '24BG' depth 24); "
                f"convert with: {conversion_hint(path)}"
            )
        raise CalibrationError(
            f"{path}: video codec '{codec}' is compressed, and the port decodes only uncompressed "
            f"8-bit QuickTime video; convert with: {conversion_hint(path)}"
        )
    channels, order = layout
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

    if height == 0 or width == 0 or np.any(sizes != sizes[0]) or sizes[0] % height:
        raise CalibrationError(f"{path}: frames of {width}x{height} do not match the stored sample sizes")
    stride = int(sizes[0]) // height
    if stride < width * channels:
        raise CalibrationError(f"{path}: {sizes[0]} bytes a sample are too few for {width}x{height} {order}")
    return Track(width, height, channels, order, stride, offsets, int(timescale), deltas)


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


class RawQuickTimeWriter:
    """Writes frames as uncompressed QuickTime: grey 8-bit (``'raw '``
    depth 40) or packed RGB (``'raw '`` depth 24), rows unpadded. The frame
    data follows a ``wide`` placeholder in one ``mdat``, which becomes a
    64-bit ``mdat`` header past 4 GiB; the movie header is written by
    `close`."""

    def __init__(self, path, size: tuple[int, int], fps: float, order: str = "gray"):
        if order not in ("gray", "rgb"):
            raise ValueError(f"order must be 'gray' or 'rgb', got {order!r}")
        self.path = Path(path)
        self.width, self.height = (int(v) for v in size)
        self.channels = 1 if order == "gray" else 3
        self.order = order
        rate = Fraction(fps).limit_denominator(100_000)
        if rate <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        self.timescale, self.delta = rate.numerator, rate.denominator
        self.count = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(_box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  "))
        self._mdat_at = self._f.tell()
        self._f.write(_box(b"wide") + struct.pack(">I4s", 8, b"mdat"))
        self._data_at = self._f.tell()

    def write(self, frame: np.ndarray) -> None:
        shape = (self.height, self.width) if self.channels == 1 else (self.height, self.width, 3)
        frame = np.asarray(frame)
        if frame.shape != shape or frame.dtype != np.uint8:
            raise ValueError(f"expected a {shape} uint8 frame, got {frame.shape} {frame.dtype}")
        if self.channels == 1:
            frame = np.invert(frame)  # white is 0 in QuickTime's 8-bit grey
        self._f.write(np.ascontiguousarray(frame).tobytes())
        self.count += 1

    def _moov(self) -> bytes:
        n, frame_bytes = self.count, self.width * self.height * self.channels
        media_duration = n * self.delta
        movie_duration = round(media_duration * 1000 / self.timescale)
        unity = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        mvhd = _box(b"mvhd", struct.pack(">IIIII", 0, 0, 0, 1000, movie_duration),
                    struct.pack(">IH10x", 0x10000, 0x100), unity, bytes(24), struct.pack(">I", 2))
        tkhd = _box(b"tkhd", struct.pack(">IIIIII", 3, 0, 0, 1, 0, movie_duration), bytes(8),
                    struct.pack(">HHHH", 0, 0, 0, 0), unity,
                    struct.pack(">II", self.width << 16, self.height << 16))
        elst = _box(b"edts", _box(b"elst", struct.pack(">IIIII", 0, 1, movie_duration, 0, 0x10000)))
        mdhd = _box(b"mdhd", struct.pack(">IIIIIHH", 0, 0, 0, self.timescale, media_duration, 0x7FFF, 0))
        hdlr = _box(b"hdlr", struct.pack(">I4s4s", 0, b"mhlr", b"vide"), bytes(12), b"\x0cVideoHandler")
        name = bytes(32)
        entry = _box(
            b"raw ", bytes(6), struct.pack(">H", 1), struct.pack(">HH4sII", 0, 0, b"FFMP", 0, 0x400),
            struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1), name,
            struct.pack(">Hh", 40 if self.channels == 1 else 24, -1),
        )
        offset = self._data_at
        chunk = (_box(b"stco", struct.pack(">III", 0, 1, offset)) if offset < 2**32
                 else _box(b"co64", struct.pack(">IIQ", 0, 1, offset)))
        stbl = _box(
            b"stbl",
            _box(b"stsd", struct.pack(">II", 0, 1), entry),
            _box(b"stts", struct.pack(">IIII", 0, 1, n, self.delta)),
            _box(b"stsc", struct.pack(">IIIII", 0, 1, 1, n, 1)),
            _box(b"stsz", struct.pack(">III", 0, frame_bytes, n)),
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

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            mdat_size = 8 + self.count * self.width * self.height * self.channels
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

    def __enter__(self) -> "RawQuickTimeWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
