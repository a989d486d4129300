"""Baseline JPEG decoding in numpy: the plain version of the nvJPEG decode
(`media/nvjpeg.py`), for MJPEG frames that are read on the CPU.

The JAX package decodes MJPEG through OpenCV's FFmpeg. This module decodes
baseline (SOF0, and SOF1's 8-bit Huffman form) JPEG: quantisation tables
(DQT), Huffman tables (DHT), interleaved and single-component scans (SOS),
restart intervals (DRI and the RST markers), grey and YCbCr images at any
sampling (4:4:4, 4:2:2 and 4:2:0 among them). The inverse DCT is libjpeg's
integer "islow" (jidctint.c: 13-bit constants, two passes), so each plane
equals libjpeg's to the bit. It returns the component planes at their own
sampling; `media.colour` turns them into BGR or grey. Progressive,
lossless, arithmetic-coded and 12-bit JPEG raise `CalibrationError`.

The Huffman decoding is a Python loop over symbols (a 16-bit lookup table
a table); the rest is vectorised over all blocks of a frame.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass

import numpy as np

from caliscope_tpu_torch.exceptions import CalibrationError

# zig-zag position k -> natural (row-major) position in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

_SOF_NAMES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
    0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive", 0xCF: "arithmetic-coded hierarchical lossless",
}
# a marker that ends entropy-coded data: 0xFF followed by neither a stuffed
# zero nor a restart marker
_END_OF_SCAN = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


@dataclass(frozen=True)
class JpegPlanes:
    """A decoded JPEG: one uint8 plane a component (Y, or Y Cb Cr), each at
    its own sampling, ceil(width * h / h_max) x ceil(height * v / v_max)."""

    width: int
    height: int
    planes: tuple[np.ndarray, ...]


def _huffman_lut(counts: bytes, symbols: bytes) -> list[int]:
    """16-bit peek -> (code length << 8) | symbol; 0 where no code starts."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise CalibrationError("JPEG Huffman table with more codes than its lengths allow")
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow on (n, 8, 8) dequantised coefficients ->
    (n, 8, 8) uint8 samples."""

    def one_pass(x, shift):  # x[..., k]: the k-th input along the transformed axis
        z2, z3 = x[..., 2], x[..., 6]
        z1 = (z2 + z3) * 4433
        tmp2 = z1 - z3 * 15137
        tmp3 = z1 + z2 * 6270
        tmp0 = (x[..., 0] + x[..., 4]) << 13
        tmp1 = (x[..., 0] - x[..., 4]) << 13
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * 9633
        t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
        half = 1 << (shift - 1)
        out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
        return np.stack([(v + half) >> shift for v in out], axis=-1)

    work = one_pass(coef.transpose(0, 2, 1), 13 - 2)  # columns: (n, col, row)
    out = one_pass(work.transpose(0, 2, 1), 13 + 2 + 3)  # rows: (n, row, col)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


class _Scan:
    """Entropy-coded data of one scan, unstuffed, with the bit position at
    which each restart interval begins."""

    def __init__(self, data: bytes):
        segments = _RESTART.split(data)
        starts, parts, at = [], [], 0
        for seg in segments:
            seg = seg.replace(b"\xff\x00", b"\xff")
            starts.append(at * 8)
            parts.append(seg)
            at += len(seg)
        raw = np.frombuffer(b"".join(parts) + b"\x00" * 4, np.uint8).astype(np.int64)
        # the 32 bits from each byte on, so that a 16-bit peek is one lookup
        self.words = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8) | raw[3:]).tolist()
        self.restarts = starts
        self.nbits = at * 8


def _decode_scan(scan: _Scan, units, dc_luts, ac_luts, restart_interval: int, n_mcus: int):
    """Huffman-decode a scan. `units` lists, MCU by MCU, the (component,
    block) each data unit of the MCU fills. Returns, for each component,
    the flat (block * 64 + natural position) indices and the values."""
    words = scan.words
    n_comp = len(dc_luts)
    idx = [[] for _ in range(n_comp)]
    val = [[] for _ in range(n_comp)]
    pred = [0] * n_comp
    p = 0
    interval = 0
    zz = ZIGZAG.tolist()
    per_mcu = len(units) // max(n_mcus, 1)
    for m in range(n_mcus):
        if restart_interval and m and m % restart_interval == 0:
            interval += 1
            if interval >= len(scan.restarts):
                raise CalibrationError("JPEG scan has fewer restart markers than its MCUs need")
            p = scan.restarts[interval]
            pred = [0] * n_comp
        for comp, block in units[m * per_mcu : (m + 1) * per_mcu]:
            dc_lut, ac_lut = dc_luts[comp], ac_luts[comp]
            out_i, out_v = idx[comp], val[comp]
            base = block * 64
            e = dc_lut[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise CalibrationError("JPEG scan holds a code its DC table does not define")
            p += e >> 8
            s = e & 0xFF
            diff = 0
            if s:
                diff = ((words[p >> 3] >> (16 - (p & 7))) & 0xFFFF) >> (16 - s)
                if diff < 1 << (s - 1):
                    diff -= (1 << s) - 1
                p += s
            pred[comp] += diff
            out_i.append(base)
            out_v.append(pred[comp])
            k = 1
            while k < 64:
                e = ac_lut[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise CalibrationError("JPEG scan holds a code its AC table does not define")
                p += e >> 8
                rs = e & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise CalibrationError("JPEG block runs past 64 coefficients")
                    v = ((words[p >> 3] >> (16 - (p & 7))) & 0xFFFF) >> (16 - s)
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    p += s
                    out_i.append(base + zz[k])
                    out_v.append(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:  # end of block
                    break
            if p > scan.nbits:
                raise CalibrationError("JPEG scan data is cut short")
    return idx, val


def decode(data: bytes) -> JpegPlanes:
    """Decode one baseline JPEG (SOI ... EOI) into its component planes."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise CalibrationError("not a JPEG image (no SOI marker)")
    qt: dict[int, np.ndarray] = {}
    dc_tables: dict[int, list[int]] = {}
    ac_tables: dict[int, list[int]] = {}
    frame = None  # (width, height, [(id, h, v, tq)])
    coefs: list[np.ndarray] = []
    restart_interval = 0
    at = 2
    while True:
        while at < len(data) and data[at] == 0xFF and at + 1 < len(data) and data[at + 1] == 0xFF:
            at += 1  # fill bytes
        if at + 2 > len(data) or data[at] != 0xFF:
            raise CalibrationError("JPEG data ends before its EOI marker")
        marker = data[at + 1]
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:  # standalone markers carry no length
            at += 2
            continue
        length = struct.unpack(">H", data[at + 2 : at + 4])[0]
        body = data[at + 4 : at + 2 + length]
        at += 2 + length
        if marker == 0xDB:
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                n = 128 if pq else 64
                table = np.frombuffer(body, ">u2" if pq else np.uint8, count=64, offset=o + 1).astype(np.int64)
                qt[tq] = np.empty(64, np.int64)
                qt[tq][ZIGZAG] = table
                o += 1 + n
        elif marker == 0xC4:
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = body[o + 1 : o + 17]
                n = sum(counts)
                lut = _huffman_lut(counts, body[o + 17 : o + 17 + n])
                (ac_tables if tc else dc_tables)[th] = lut
                o += 17 + n
        elif marker == 0xDD:
            restart_interval = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC1):
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise CalibrationError(f"{precision}-bit JPEG is not decoded (baseline 8-bit only)")
            if height == 0:
                raise CalibrationError("JPEG with the height set by a DNL marker is not decoded")
            comps = [tuple(body[6 + 3 * i : 9 + 3 * i]) for i in range(nc)]
            comps = [(cid, hv >> 4, hv & 15, tq) for cid, hv, tq in comps]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            frame = (width, height, comps, hmax, vmax, mcux, mcuy)
            coefs = [np.zeros((mcuy * v * 8 * 8 * mcux * h,), np.int64) for _, h, v, _ in comps]
        elif marker in _SOF_NAMES:
            raise CalibrationError(f"{_SOF_NAMES[marker]} JPEG is not decoded (baseline only)")
        elif marker == 0xDA:
            if frame is None:
                raise CalibrationError("JPEG scan before its frame header")
            width, height, comps, hmax, vmax, mcux, mcuy = frame
            ns = body[0]
            sel = [(body[1 + 2 * i], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, ahal = body[1 + 2 * ns : 4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise CalibrationError("JPEG scan is not sequential (spectral selection or approximation)")
            ids = [c[0] for c in comps]
            which = [ids.index(cid) for cid, _, _ in sel]
            end = _END_OF_SCAN.search(data, at)
            if end is None:
                raise CalibrationError("JPEG scan has no end marker")
            scan = _Scan(data[at : end.start()])
            at = end.start()
            try:
                dc = [dc_tables[td] for _, td, _ in sel]
                ac = [ac_tables[ta] for _, _, ta in sel]
            except KeyError as e:
                raise CalibrationError(f"JPEG scan names Huffman table {e} that is not defined") from None
            units = []
            if ns == 1:  # non-interleaved: the component's own blocks, in raster order
                c = which[0]
                _, h, v, _ = comps[c]
                bw, bh = -(-(-(-width * h // hmax)) // 8), -(-(-(-height * v // vmax)) // 8)
                stride = mcux * h
                units = [(0, r * stride + col) for r in range(bh) for col in range(bw)]
                n_mcus = bw * bh
            else:
                for my in range(mcuy):
                    for mx in range(mcux):
                        for j, c in enumerate(which):
                            _, h, v, _ = comps[c]
                            stride = mcux * h
                            units.extend((j, (my * v + y) * stride + mx * h + x) for y in range(v) for x in range(h))
                n_mcus = mcux * mcuy
            idx, val = _decode_scan(scan, units, dc, ac, restart_interval, n_mcus)
            for j, c in enumerate(which):
                coefs[c][np.asarray(idx[j], np.int64)] = np.asarray(val[j], np.int64)
        # APPn, COM and the rest carry nothing the decode needs
    if frame is None or not coefs:
        raise CalibrationError("JPEG without a frame header or scan")
    width, height, comps, hmax, vmax, mcux, mcuy = frame
    planes = []
    for (cid, h, v, tq), c in zip(comps, coefs):
        if tq not in qt:
            raise CalibrationError(f"JPEG component {cid} names quantisation table {tq} that is not defined")
        bh, bw = mcuy * v, mcux * h
        blocks = _idct_islow((c.reshape(-1, 64) * qt[tq]).reshape(-1, 8, 8))
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        planes.append(np.ascontiguousarray(plane[: -(-height * v // vmax), : -(-width * h // hmax)]))
    if len(planes) not in (1, 3):
        raise CalibrationError(f"JPEG with {len(planes)} components is not decoded (grey or YCbCr only)")
    return JpegPlanes(width, height, tuple(planes))
