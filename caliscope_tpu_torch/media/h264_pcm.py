"""A lossless H.264 writer for test clips: I_PCM macroblocks and skips.

Like `targets/render.py` and `RawQuickTimeWriter`, this exists so that the
tests and chip_smoke.py can make compressed recordings without OpenCV. The
stream is constrained-baseline H.264 (profile 66, level_idc 52, CAVLC) in
an MP4 (``'avc1'`` with ``avcC``), 4:2:0 at 8 bits:

- an IDR frame, at the start of each group of pictures, is one slice of
  I_PCM macroblocks (``mb_type`` 25, alignment bits, 384 sample bytes);
- every other frame is one P slice: the macroblocks that differ from the
  previous frame are I_PCM (``mb_type`` 30 in a P slice), each run of
  unchanged ones is one ``mb_skip_run``. Every motion vector is zero (a
  P_Skip predicts from neighbours whose vectors are all zero), so a
  skipped macroblock copies the reference exactly;
- deblocking is off and emulation-prevention bytes are inserted (sample
  bytes hold zeros).

So a decoder gives back the written planes bit for bit. Frame sizes that
are not multiples of 16 are padded by repeating the edge and cropped in
the SPS. The VUI states the range (``video_full_range_flag``); luma
written from a grey frame is either the grey itself (full range) or
16 + 219/255 of it (limited range, what cameras write).
"""

from __future__ import annotations

import re

import numpy as np

from caliscope_tpu_torch.media.quicktime import MovieWriter, _box, visual_entry

PROFILE_IDC, LEVEL_IDC = 66, 52
LOG2_MAX_FRAME_NUM = 8
# 0x00 0x00 followed by a byte <= 3 takes an emulation-prevention 0x03
_EMULATION = re.compile(rb"\x00\x00(?=[\x00-\x03])")


class _Bits:
    """An RBSP written bit by bit (the headers and macroblock prefixes)."""

    def __init__(self):
        self.bits: list[str] = []

    def u(self, n: int, value: int) -> "_Bits":
        if n:
            self.bits.append(format(value, f"0{n}b"))
        return self

    def ue(self, value: int) -> "_Bits":
        code = format(value + 1, "b")
        self.bits.append("0" * (len(code) - 1) + code)
        return self

    def se(self, value: int) -> "_Bits":
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self) -> "_Bits":
        self.bits.append("0" * (-len("".join(self.bits)) % 8))
        return self

    def trailing(self) -> bytes:
        self.bits.append("1")
        return self.align_zero().bytes()

    def bytes(self) -> bytes:
        s = "".join(self.bits)
        if len(s) % 8:
            raise ValueError("the RBSP is not byte-aligned")
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes) -> bytes:
    """One NAL unit (header and escaped payload), without a length prefix."""
    return bytes([(nal_ref_idc << 5) | nal_unit_type]) + _EMULATION.sub(b"\x00\x00\x03", rbsp)


def luma_from_gray(gray: np.ndarray, full_range: bool) -> np.ndarray:
    """The luma a camera would record for a grey frame: the grey itself at
    full range, round(16 + gray * 219 / 255) at limited range."""
    gray = np.asarray(gray, np.uint8)
    if full_range:
        return gray
    return ((gray.astype(np.int32) * 2 * 219 + 2 * 16 * 255 + 255) // (2 * 255)).astype(np.uint8)


class H264PcmWriter(MovieWriter):
    """Writes (H, W) uint8 luma planes, with 128 for both chroma planes, as
    lossless H.264 in an MP4. Each `gop` frames start with an IDR frame
    (a sync sample); the rest are P frames coded against the frame before."""

    def __init__(self, path, size: tuple[int, int], fps: float, *, gop: int = 12, full_range: bool = False):
        super().__init__(path, size, fps, b"isom")
        if gop < 1:
            raise ValueError(f"gop must be positive, got {gop}")
        self.gop, self.full_range = int(gop), bool(full_range)
        self.mbw, self.mbh = -(-self.width // 16), -(-self.height // 16)
        self._prev: np.ndarray | None = None  # the previous frame's (n_mb, 384) samples
        self._idr_count = 0
        self.sps, self.pps = self._sps(), self._pps()

    def _sps(self) -> bytes:
        b = _Bits().u(8, PROFILE_IDC).u(8, 0b11000000).u(8, LEVEL_IDC).ue(0)  # constraint_set0/1: constrained baseline
        b.ue(LOG2_MAX_FRAME_NUM - 4).ue(2)  # pic_order_cnt_type 2: display order = decode order
        b.ue(1).u(1, 0).ue(self.mbw - 1).ue(self.mbh - 1).u(1, 1).u(1, 1)  # refs, sizes, frame_mbs_only, direct_8x8
        crop_r, crop_b = (self.mbw * 16 - self.width) // 2, (self.mbh * 16 - self.height) // 2
        if crop_r or crop_b:
            b.u(1, 1).ue(0).ue(crop_r).ue(0).ue(crop_b)
        else:
            b.u(1, 0)
        b.u(1, 1)  # vui_parameters_present_flag
        b.u(1, 0).u(1, 0).u(1, 1).u(3, 5).u(1, int(self.full_range)).u(1, 0)  # video_signal_type: unspecified format
        b.u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0)  # no chroma location, timing, HRDs, pic_struct
        # bitstream_restriction: no reordering and one frame buffered, so a
        # decoder shows each frame as soon as it is decoded
        b.u(1, 1).u(1, 1).ue(0).ue(0).ue(16).ue(16).ue(0).ue(1)
        return nal(3, 7, b.trailing())

    def _pps(self) -> bytes:
        b = _Bits().ue(0).ue(0).u(1, 0).u(1, 0).ue(0).ue(0).ue(0).u(1, 0).u(2, 0).se(0).se(0).se(0)
        b.u(1, 1).u(1, 0).u(1, 0)  # deblocking_filter_control_present, no constrained intra, no redundant_pic_cnt
        return nal(3, 8, b.trailing())

    def _entry(self) -> bytes:
        avcc = bytes([1, PROFILE_IDC, 0b11000000, LEVEL_IDC, 0xFF, 0xE1]) + len(self.sps).to_bytes(2, "big") + self.sps
        avcc += bytes([1]) + len(self.pps).to_bytes(2, "big") + self.pps
        return visual_entry(b"avc1", self.width, self.height, 24, _box(b"avcC", avcc))

    def _macroblocks(self, luma: np.ndarray) -> np.ndarray:
        """(n_mb, 384): each macroblock's 256 luma then 64 Cb and 64 Cr samples."""
        h16, w16 = self.mbh * 16, self.mbw * 16
        y = np.pad(luma, ((0, h16 - self.height), (0, w16 - self.width)), mode="edge")
        y = y.reshape(self.mbh, 16, self.mbw, 16).transpose(0, 2, 1, 3).reshape(-1, 256)
        return np.concatenate([y, np.full((y.shape[0], 128), 128, np.uint8)], axis=1)

    def write(self, luma: np.ndarray) -> None:
        luma = np.asarray(luma)
        if luma.shape != (self.height, self.width) or luma.dtype != np.uint8:
            raise ValueError(f"expected a {(self.height, self.width)} uint8 luma plane, got {luma.shape} {luma.dtype}")
        mbs = self._macroblocks(luma)
        idr = self.count % self.gop == 0
        frame_num = (self.count % self.gop) % (1 << LOG2_MAX_FRAME_NUM)
        head = _Bits().ue(0).ue(7 if idr else 5).ue(0).u(LOG2_MAX_FRAME_NUM, frame_num)
        if idr:
            head.ue(self._idr_count % 65536)
            self._idr_count += 1
            head.u(1, 0).u(1, 0)  # dec_ref_pic_marking: no_output_of_prior_pics, not long-term
        else:
            head.u(1, 0).u(1, 0).u(1, 0)  # no ref count override, no list modification, sliding window
        head.se(0).ue(1)  # slice_qp_delta, disable_deblocking_filter_idc 1
        changed = np.ones(len(mbs), bool) if idr else np.any(mbs != self._prev, axis=1)
        parts: list[bytes] = []
        bits, done = head, 0  # done: macroblocks coded or skipped so far
        for i in np.flatnonzero(changed).tolist():
            if not idr:
                bits.ue(i - done)  # mb_skip_run before this macroblock
            bits.ue(25 if idr else 30).align_zero()  # I_PCM, then pcm_alignment_zero_bits
            parts += [bits.bytes(), mbs[i].tobytes()]
            bits, done = _Bits(), i + 1
        if done < len(mbs):
            bits.ue(len(mbs) - done)
        parts.append(bits.trailing())
        self._prev = mbs
        unit = nal(3 if idr else 2, 5 if idr else 1, b"".join(parts))
        sample = len(unit).to_bytes(4, "big") + unit
        self._write_sample(sample, sync=idr)
