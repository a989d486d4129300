"""A baseline JPEG encoder for grey frames, and an MJPEG writer, for test
clips and recordings that need no OpenCV (like `media/h264_pcm.py`).

`encode_gray(frame, quality)` writes one baseline (SOF0) JPEG of a single
component: libjpeg's luminance table scaled by `quality` (100: every step
1), a float DCT rounded to the nearest step, and Huffman tables of fixed
length (4-bit DC categories, 8-bit AC symbols), which every baseline
decoder takes. Everything is vectorised over the frame's blocks.
`MjpegWriter` stores one such JPEG a sample under QuickTime's ``'jpeg'``
entry, the layout FFmpeg writes for MJPEG in ``.mov``.
"""

from __future__ import annotations

import struct

import numpy as np

from caliscope_tpu_torch.media.jpeg import ZIGZAG
from caliscope_tpu_torch.media.quicktime import MovieWriter, visual_entry

# libjpeg's luminance quantisation table (ITU-T T.81 Annex K.1), row-major
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
# the AC symbols (run << 4 | size), EOB and ZRL first, each coded in 8 bits
# by its place in this list
_AC_SYMBOLS = np.array([0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)], np.int64)
_AC_CODE = np.zeros(256, np.int64)
_AC_CODE[_AC_SYMBOLS] = np.arange(len(_AC_SYMBOLS))
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def quant_table(quality: int) -> np.ndarray:
    """libjpeg's scaling of the luminance table (jcparam.c), row-major."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_LUMA_Q * scale + 50) // 100, 1, 255)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _categories(v: np.ndarray):
    """JPEG's size category of each value and its extra bits."""
    size = np.zeros(v.shape, np.int64)
    mag = np.abs(v)
    nz = mag > 0
    size[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    extra = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, extra


def encode_gray(frame: np.ndarray, quality: int = 100) -> bytes:
    """One grey (H, W) uint8 frame as a baseline single-component JPEG."""
    frame = np.asarray(frame)
    if frame.ndim != 2 or frame.dtype != np.uint8:
        raise ValueError(f"expected an (H, W) uint8 frame, got {frame.shape} {frame.dtype}")
    h, w = frame.shape
    q = quant_table(quality)
    pad = np.pad(frame.astype(np.float64) - 128.0, ((0, -h % 8), (0, -w % 8)), mode="edge")
    bh, bw = pad.shape[0] // 8, pad.shape[1] // 8
    blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT).reshape(-1, 64)
    zz = np.rint(coef / q).astype(np.int64)[:, ZIGZAG]  # zig-zag order
    n = len(zz)

    # items (block, order within the block, bits, count of bits), sorted at the end
    keys, vals, lens = [], [], []
    dc = np.diff(zz[:, 0], prepend=0)
    size, extra = _categories(dc)
    blk = np.arange(n)
    keys += [blk * 512, blk * 512 + 1]
    vals += [size, extra]
    lens += [np.full(n, 4), size]
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    prev = np.where(np.r_[True, b[1:] != b[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    zrl = run // 16
    zb = np.repeat(b, zrl)
    keys.append(zb * 512 + np.repeat(4 * k, zrl))
    vals.append(np.full(len(zb), _AC_CODE[0xF0]))
    lens.append(np.full(len(zb), 8))
    size, extra = _categories(v)
    keys += [b * 512 + 4 * k + 2, b * 512 + 4 * k + 3]
    vals += [_AC_CODE[((run % 16) << 4) | size], extra]
    lens += [np.full(len(b), 8), size]
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 512 + 300)
    vals.append(np.full(len(eob), _AC_CODE[0x00]))
    lens.append(np.full(len(eob), 8))
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]

    # pack the items' bits, most significant first; pad the last byte with 1s
    total = int(lens.sum())
    start = np.repeat(np.cumsum(lens) - lens, lens)
    shift = np.repeat(lens, lens) - 1 - (np.arange(total) - start)
    bits = (np.repeat(vals, lens) >> shift) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")

    dqt = _segment(0xDB, bytes([0]) + q[ZIGZAG].astype(np.uint8).tobytes())
    sof = _segment(0xC0, struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0]))
    dht = _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
                   + bytes([0x10]) + bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8)
                   + _AC_SYMBOLS.astype(np.uint8).tobytes())
    sos = _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
    return b"\xff\xd8" + dqt + sof + dht + sos + data + b"\xff\xd9"


class MjpegWriter(MovieWriter):
    """Writes (H, W) uint8 grey frames as MJPEG QuickTime (``'jpeg'``), one
    baseline JPEG of `quality` a sample."""

    def __init__(self, path, size: tuple[int, int], fps: float, quality: int = 100):
        super().__init__(path, size, fps, b"qt  ")
        quant_table(quality)
        self.quality = int(quality)

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.shape != (self.height, self.width):
            raise ValueError(f"expected a {(self.height, self.width)} frame, got {frame.shape}")
        self._write_sample(encode_gray(frame, self.quality))

    def _entry(self) -> bytes:
        return visual_entry(b"jpeg", self.width, self.height, 24)
