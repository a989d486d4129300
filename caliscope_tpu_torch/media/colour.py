"""YUV -> BGR / grey as the JAX package sees a decoded frame.

The JAX package's frame is OpenCV's BGR (FFmpeg's swscale from the
decoder's YUV), then cv2.cvtColor(BGR2GRAY) for a grey tracker. This is
that step in plain torch ops, for the planes the port's decoders give: the
BT.601 matrix at the stream's range (full for JPEG, limited for MPEG-4
Part 2 and for H.264 without the full-range flag), chroma taken from the
nearest sample, rounded and clipped to 8 bits, then OpenCV's 15-bit grey
weights (`bgr_to_gray`, which the uncompressed reader uses too). It runs
on the card for frames the card decoded and on the CPU for MJPEG decoded
in numpy. It is not bit-exact to swscale, whose fixed-point tables round
otherwise: the decode tests state the largest difference they meet.
"""

from __future__ import annotations

import torch

# OpenCV's fixed-point BGR -> grey weights (b, g, r) over 2^15, which
# cvtColor(COLOR_BGR2GRAY) applies to 8-bit frames
GRAY_WEIGHTS = (3735, 19235, 9798)

# (luma offset, luma scale, Cr -> R, Cb -> G, Cr -> G, Cb -> B)
_BT601 = {
    True: (0.0, 1.0, 1.402, -0.344136, -0.714136, 1.772),  # JFIF full range
    False: (16.0, 255.0 / 219.0, 1.596027, -0.391762, -0.812968, 2.017232),  # limited range
}


def _upsample(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest upsampling of a chroma plane to h x w (each sample covers
    ceil(h / rows) x ceil(w / cols) pixels)."""
    fy, fx = -(-h // c.shape[-2]), -(-w // c.shape[-1])
    if fy > 1:
        c = c.repeat_interleave(fy, dim=-2)
    if fx > 1:
        c = c.repeat_interleave(fx, dim=-1)
    return c[..., :h, :w]


def yuv_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, full_range: bool) -> torch.Tensor:
    """(..., H, W) uint8 luma and (..., h, w) uint8 Cb, Cr planes at any
    subsampling -> (..., H, W, 3) uint8 BGR, on the planes' device."""
    off, scale, rv, gu, gv, bu = _BT601[bool(full_range)]
    h, w = y.shape[-2:]
    yf = (y.float() - off) * scale
    uf = _upsample(u, h, w).float() - 128.0
    vf = _upsample(v, h, w).float() - 128.0
    bgr = torch.stack((yf + bu * uf, yf + gu * uf + gv * vf, yf + rv * vf), dim=-1)
    return bgr.round_().clamp_(0, 255).to(torch.uint8)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) uint8, as cv2.cvtColor(BGR2GRAY)."""
    b, g, r = (bgr[..., i].to(torch.int32) for i in range(3))
    wb, wg, wr = GRAY_WEIGHTS
    return ((b * wb + g * wg + r * wr + (1 << 14)) >> 15).to(torch.uint8)


def yuv_to_frame(y, u, v, full_range: bool, gray: bool) -> torch.Tensor:
    """The frame the JAX package would hand a tracker: BGR, or its grey.
    A grey JPEG (no chroma planes: u and v None) is its luma as it is."""
    if u is None:
        return y if gray else y.unsqueeze(-1).expand(*y.shape, 3).contiguous()
    bgr = yuv_to_bgr(y, u, v, full_range)
    return bgr_to_gray(bgr) if gray else bgr
