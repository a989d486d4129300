"""Uncompressed grey QuickTime (`'raw '`, depth 40: 8-bit grey, white = 0,
rows unpadded, one sample a frame, every sample a sync sample), the format
the workspace's cameras are converted to for extraction. A frozen copy of
the layout the port's `media/quicktime.py` writes, so the benchmark makes
its own inputs."""

from __future__ import annotations

import struct
from fractions import Fraction
from pathlib import Path

import numpy as np


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _moov(width, height, timescale, delta, n, frame_bytes, data_at):
    media = n * delta
    movie = round(media * 1000 / timescale)
    unity = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    mvhd = _box(b"mvhd", struct.pack(">IIIII", 0, 0, 0, 1000, movie),
                struct.pack(">IH10x", 0x10000, 0x100), unity, bytes(24), struct.pack(">I", 2))
    tkhd = _box(b"tkhd", struct.pack(">IIIIII", 3, 0, 0, 1, 0, movie), bytes(8),
                struct.pack(">HHHH", 0, 0, 0, 0), unity, struct.pack(">II", width << 16, height << 16))
    edts = _box(b"edts", _box(b"elst", struct.pack(">IIIII", 0, 1, movie, 0, 0x10000)))
    mdhd = _box(b"mdhd", struct.pack(">IIIIIHH", 0, 0, 0, timescale, media, 0x7FFF, 0))
    hdlr = _box(b"hdlr", struct.pack(">I4s4s", 0, b"mhlr", b"vide"), bytes(12), b"\x0cVideoHandler")
    entry = _box(
        b"raw ", bytes(6), struct.pack(">H", 1), struct.pack(">HH4sII", 0, 0, b"FFMP", 0, 0x400),
        struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32), struct.pack(">Hh", 40, -1),
    )
    chunk = (_box(b"stco", struct.pack(">III", 0, 1, data_at)) if data_at < 2**32
             else _box(b"co64", struct.pack(">IIQ", 0, 1, data_at)))
    stbl = _box(
        b"stbl",
        _box(b"stsd", struct.pack(">II", 0, 1), entry),
        _box(b"stts", struct.pack(">IIII", 0, 1, n, delta)),
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
    return _box(b"moov", mvhd, _box(b"trak", tkhd, edts, _box(b"mdia", mdhd, hdlr, minf)))


def write_gray(path, frames: np.ndarray, fps: float) -> None:
    """Write (F, h, w) uint8 `frames` to `path` as grey QuickTime at `fps`."""
    frames = np.asarray(frames)
    if frames.ndim != 3 or frames.dtype != np.uint8 or len(frames) == 0:
        raise ValueError(f"expected (F, h, w) uint8 frames, got {frames.shape} {frames.dtype}")
    n, h, w = frames.shape
    rate = Fraction(fps).limit_denominator(100_000)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = np.invert(np.ascontiguousarray(frames))  # white is 0 in QuickTime's 8-bit grey
    with open(path, "wb") as f:
        f.write(_box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  "))
        size = 8 + data.nbytes
        if size >= 2**32:
            raise ValueError("a grey QuickTime file here holds under 4 GiB of frames")
        f.write(_box(b"wide") + struct.pack(">I4s", size, b"mdat"))
        data_at = f.tell()
        data.tofile(f)
        f.write(_moov(w, h, rate.numerator, rate.denominator, n, h * w, data_at))
