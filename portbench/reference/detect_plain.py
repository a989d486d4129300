"""Frozen plain copies of the port's kernels 2-4, the yardstick they are
held to with `torch.equal` at the cells' own inputs.

- `connected_components`: 4-connected labeling of a (B, H, W) bool mask by
  `n_iters` rounds of segmented running-min scans along rows and columns;
  labels are int32 linear pixel indices, background H * W (the port's
  detect/kernels.py::connected_components, csrc/ccl.cu's function).
- `corner_response`: the 16-tap ring response in single IEEE float32
  operations in a fixed order, rows blended first, sums left to right, a
  zeroed border of 6 (detect/cuda_kernels.py::corner_response_plain,
  csrc/corner_response.cu's function).
- `extract_windows`: out[b, k, r, c] = frames[b, y + r, x + c] with the
  seeds clamped into the frame (csrc/extract_windows.cu's function).

`dtype` runs the response in another precision: the control.
Imports nothing of the program.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

N_TAPS = 16
RADIUS = 4.0
PAD = 6


def _segmented_min_scan(values, connected, reverse=False):
    n, rows = values.shape[-1], values.shape[-2]
    M = n * rows + 1
    if reverse:
        values = torch.flip(values, dims=(-1,))
        connected = torch.flip(connected, dims=(-1,)).clone()
        connected[..., 0] = False
    seg_id = torch.cumsum(~connected, dim=-1, dtype=torch.int64)
    run = torch.cummin(values.to(torch.int64) - seg_id * M, dim=-1).values
    out = (run + seg_id * M).to(torch.int32)
    return torch.flip(out, dims=(-1,)) if reverse else out


def connected_components(mask, n_iters):
    B, H, W = mask.shape
    dev = mask.device
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W)
    bg = torch.tensor(H * W, dtype=torch.int32, device=dev)
    labels = torch.where(mask, idx, bg)
    pair_h = mask[:, :, 1:] & mask[:, :, :-1]
    mt = mask.transpose(1, 2)
    pair_v = mt[:, :, 1:] & mt[:, :, :-1]
    no_h = torch.zeros((B, H, 1), dtype=torch.bool, device=dev)
    no_v = torch.zeros((B, W, 1), dtype=torch.bool, device=dev)
    conn_h, conn_hr = torch.cat([no_h, pair_h], dim=2), torch.cat([pair_h, no_h], dim=2)
    conn_v, conn_vr = torch.cat([no_v, pair_v], dim=2), torch.cat([pair_v, no_v], dim=2)
    for _ in range(n_iters):
        labels = _segmented_min_scan(labels, conn_h)
        labels = _segmented_min_scan(labels, conn_hr, reverse=True)
        lt = labels.transpose(1, 2).contiguous()
        lt = _segmented_min_scan(lt, conn_v)
        lt = _segmented_min_scan(lt, conn_vr, reverse=True)
        labels = torch.where(mask, lt.transpose(1, 2), bg)
    return labels.contiguous()


def ring_taps():
    """(offsets (16, 2) [iy, ix], weights (16, 4) float32 [1-fy, fy, 1-fx, fx])."""
    ang = 2 * np.pi * np.arange(N_TAPS) / N_TAPS
    ring = np.stack([RADIUS * np.cos(ang), RADIUS * np.sin(ang)], axis=1)
    offsets = np.empty((N_TAPS, 2), np.int32)
    weights = np.empty((N_TAPS, 4), np.float32)
    for k, (dx, dy) in enumerate(ring):
        iy, ix = int(np.floor(dy)), int(np.floor(dx))
        fy, fx = float(dy - iy), float(dx - ix)
        offsets[k] = (iy, ix)
        weights[k] = (1 - fy, fy, 1 - fx, fx)
    return offsets, weights


def corner_response(images, dtype=None):
    if dtype is not None:
        return corner_response(images.to(dtype)).to(images.dtype)
    B, H, W = images.shape
    offsets, weights = ring_taps()
    out = torch.zeros_like(images)
    Hi, Wi = H - 2 * PAD, W - 2 * PAD
    if Hi <= 0 or Wi <= 0:
        return out

    def shifted(dy, dx):
        return images[:, PAD + dy : PAD + dy + Hi, PAD + dx : PAD + dx + Wi]

    s = []
    for (iy, ix), (wy0, wy1, wx0, wx1) in zip(offsets.tolist(), weights.tolist()):
        r0 = wy0 * shifted(iy, ix) + wy1 * shifted(iy + 1, ix)
        r1 = wy0 * shifted(iy, ix + 1) + wy1 * shifted(iy + 1, ix + 1)
        s.append(wx0 * r0 + wx1 * r1)
    n = N_TAPS
    sr = sum(torch.abs(s[i] - s[i + n // 2]) for i in range(n // 2))
    dr = sum(torch.abs(s[i] - s[(i + n // 4) % n]) for i in range(n // 2))
    mean_ring = sum(s) / n
    mr = torch.abs(mean_ring - shifted(0, 0)) * (n // 2) * 0.5
    out[:, PAD : H - PAD, PAD : W - PAD] = torch.clamp(dr - sr - mr, min=0.0)
    return out


def extract_windows(frames, yi, xi, win):
    B, Hp, Wp = frames.shape
    ar = torch.arange(win, device=frames.device)
    y = yi.long().clamp(0, Hp - win)
    x = xi.long().clamp(0, Wp - win)
    b = torch.arange(B, device=frames.device)[:, None, None, None]
    return frames[b, y[:, :, None, None] + ar[:, None], x[:, :, None, None] + ar[None, :]]


# The program entries whose calls are sampled, and the plain copy each is held to.
TARGETS = {
    "ccl": ("caliscope_tpu_torch.detect.aruco:connected_components", connected_components),
    "corner_response": ("caliscope_tpu_torch.detect.corners:corner_response", corner_response),
    "windows.corners": ("caliscope_tpu_torch.detect.corners:extract_windows", extract_windows),
    "windows.atlas": ("caliscope_tpu_torch.detect.kernels:extract_windows", extract_windows),
}


class Sampler:
    """Keeps the inputs and output of a few calls of each target (the calls
    numbered in `pick[name]` while `on`), cloned on the caller's stream right
    after the call; `mismatch()` then counts the elements where the program
    differs from the plain copy."""

    def __init__(self, pick):
        self.pick, self.calls, self.kept, self.on = pick, {}, {}, False
        self._lock = threading.Lock()

    def wrap(self, name, original):
        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            if self.on:
                with self._lock:
                    n = self.calls.get(name, 0)
                    self.calls[name] = n + 1
                if n in self.pick[name]:
                    clone = [a.clone() if torch.is_tensor(a) else a for a in args]
                    self.kept.setdefault(name, []).append((clone, kwargs, out.clone()))
            return out

        return wrapper

    def mismatch(self, dtype=None):
        """{name: differing elements} of each kept call against its plain
        copy (the response in `dtype` when given), and the calls seen."""
        out = {}
        for name, calls in self.kept.items():
            plain = TARGETS[name][1]
            out[name] = 0
            for args, kwargs, got in calls:
                if name == "corner_response" and dtype is not None:
                    want = plain(*args, dtype=dtype)
                else:
                    want = plain(*args, **kwargs)
                same_kind = want.shape == got.shape and want.dtype == got.dtype
                out[name] += int((want != got).sum()) if same_kind else int(got.numel())
        return out
