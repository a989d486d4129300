"""Pose-model output decoding on torch tensors, on the tensors' device.

Port of caliscope_tpu/pose/decode.py: batched over (B, K, ...) with no
per-keypoint Python loops; both decoders refine the hard peak to subpixel
(a windowed soft-argmax for SimCC, a clamped quadratic Taylor step for
heatmaps). Argmax ties take the first index, as jnp.argmax does.
"""

from __future__ import annotations

import torch


def _soft_refine_1d(vec, idx, radius: int = 2):
    """Soft-argmax offset within +/-radius of the hard peak. vec (..., N)."""
    n = vec.shape[-1]
    offs = torch.arange(-radius, radius + 1, device=vec.device)
    pos = idx[..., None] + offs
    valid = (pos >= 0) & (pos < n)
    vals = torch.gather(vec, -1, torch.clamp(pos, 0, n - 1))
    vals = torch.where(valid, vals, torch.full_like(vals, float("-inf")))
    w = torch.softmax(vals, dim=-1)
    return torch.sum(w * offs.to(w.dtype), dim=-1)


def decode_simcc(simcc_x, simcc_y, simcc_split_ratio: float = 2.0, refine: bool = True):
    """SimCC vectors -> (keypoints (B, K, 2), confidence (B, K)).

    simcc_x: (B, K, Wx); simcc_y: (B, K, Hy) tensors. Coordinates are in
    model input space (divided by the split ratio); confidence =
    clip(min(px, py), 0, 1).
    """
    simcc_x, simcc_y = torch.as_tensor(simcc_x), torch.as_tensor(simcc_y)
    xi, yi = torch.argmax(simcc_x, dim=-1), torch.argmax(simcc_y, dim=-1)
    xc, yc = torch.amax(simcc_x, dim=-1), torch.amax(simcc_y, dim=-1)
    x = xi.to(torch.float32)
    y = yi.to(torch.float32)
    if refine:
        x = x + _soft_refine_1d(simcc_x, xi)
        y = y + _soft_refine_1d(simcc_y, yi)
    kps = torch.stack([x, y], dim=-1) / simcc_split_ratio
    conf = torch.clamp(torch.minimum(xc, yc), 0.0, 1.0)
    return kps, conf


def decode_heatmap(heatmaps, refine: bool = True):
    """Heatmaps (B, K, H, W) -> (keypoints (B, K, 2), confidence (B, K)).

    Hard argmax + quadratic Taylor subpixel step (clamped to +/-0.5),
    vectorized over batch and keypoints.
    """
    hm = torch.as_tensor(heatmaps)
    B, K, H, W = hm.shape
    flat = hm.reshape(B, K, -1)
    idx = torch.argmax(flat, dim=-1)
    conf = torch.amax(flat, dim=-1)
    y = idx // W
    x = idx % W
    if refine:
        x0 = torch.clamp(x, 1, W - 2)
        y0 = torch.clamp(y, 1, H - 2)

        def at(yy, xx):
            return torch.gather(flat, -1, (yy * W + xx)[..., None])[..., 0]

        c = at(y0, x0)
        right, left, down, up = at(y0, x0 + 1), at(y0, x0 - 1), at(y0 + 1, x0), at(y0 - 1, x0)
        dx = 0.5 * (right - left)
        dy = 0.5 * (down - up)
        dxx = right - 2 * c + left
        dyy = down - 2 * c + up
        zero = torch.zeros_like(c)
        ox = torch.where(torch.abs(dxx) > 1e-9, -dx / dxx, zero)
        oy = torch.where(torch.abs(dyy) > 1e-9, -dy / dyy, zero)
        interior = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
        ox = torch.where(interior, torch.clamp(ox, -0.5, 0.5), zero)
        oy = torch.where(interior, torch.clamp(oy, -0.5, 0.5), zero)
    else:
        ox = oy = torch.zeros_like(conf)
    kps = torch.stack([x.to(torch.float32) + ox, y.to(torch.float32) + oy], dim=-1)
    return kps, torch.clamp(conf, 0.0, 1.0)
