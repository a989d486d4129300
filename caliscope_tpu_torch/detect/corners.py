"""Chessboard X-corner detection: ring response, NMS, subpixel refinement.

Port of caliscope_tpu/detect/corners.py, which stands in for
cv2.findChessboardCorners + cv2.cornerSubPix.

- chess_corner_response: a ChESS-style ring detector (Bennett & Lasenby) —
  around an X-corner, intensity on a sampling ring alternates with period pi,
  so diametrically opposite samples agree while quarter-turn samples differ.
  This is the reference's jnp twin (edge-padded, border unmasked), kept for
  comparison; the pipeline's response is detect/cuda_kernels.py::
  corner_response, the kernel's function (border zeroed).
- nms_corners: max-pool non-maximum suppression + top-K extraction (static K).
- refine_corners_subpix: the cornerSubPix saddle condition — every image
  gradient in a window is orthogonal to the offset from the true corner:
  solve sum(w * grad gradT)(c - p) = 0, iterated over fixed window pixels.
  Its windows come from detect/cuda_kernels.py::extract_windows.

All tensor code runs in float32 on either device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from caliscope_tpu_torch.detect.cuda_kernels import corner_response, extract_windows
from caliscope_tpu_torch.device import resolve_device


def _ring_offsets(radius: float, n: int = 16) -> np.ndarray:
    ang = 2 * np.pi * np.arange(n) / n
    return np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)


def chess_corner_response(images, radius: float = 4.0):
    """(B, H, W) float -> (B, H, W) X-corner response (>= 0, higher =
    cornerier), edge-padded and unmasked at the border: the reference's
    jnp twin. Samples blend columns first, then rows."""
    B, H, W = images.shape
    offs = _ring_offsets(radius)
    n = len(offs)
    imgs = images.to(torch.float32)
    pad = int(np.ceil(radius)) + 1
    p = F.pad(imgs[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]

    def shifted(dx, dy):
        ix, iy = int(np.floor(dx)), int(np.floor(dy))
        fx, fy = dx - ix, dy - iy

        def sl(ddx, ddy):
            return p[:, pad + iy + ddy : pad + iy + ddy + H, pad + ix + ddx : pad + ix + ddx + W]

        return (
            (1 - fy) * ((1 - fx) * sl(0, 0) + fx * sl(1, 0))
            + fy * ((1 - fx) * sl(0, 1) + fx * sl(1, 1))
        )

    rs = [shifted(float(o[0]), float(o[1])) for o in offs]
    # sum response: agreement across the diameter
    sr = sum(torch.abs(rs[i] - rs[(i + n // 2) % n]) for i in range(n // 2))
    # diff response: disagreement at quarter turn
    dr = sum(torch.abs(rs[i] - rs[(i + n // 4) % n]) for i in range(n // 2))
    # local mean term suppresses edges/lines
    mean_ring = torch.stack(rs).mean(dim=0)
    mr = torch.abs(mean_ring - imgs) * (n // 2) * 0.5
    return torch.clamp(dr - sr - mr, min=0.0)


def nms_corners(response, k_max: int, rel_threshold: float = 0.2, window: int = 5, border: int = 6):
    """Top-K local maxima per frame. Returns (xy (B, K, 2) float, score (B, K),
    valid (B, K)). Exact top-k (the reference swaps in an approximate one
    on its TPU backend only); slots whose score ties at 0 are all invalid,
    so the order `torch.topk` gives equals is immaterial."""
    B, H, W = response.shape
    r = window // 2
    pooled = F.max_pool2d(response[:, None], kernel_size=window, stride=1, padding=r)[:, 0]
    is_peak = (response >= pooled) & (response > 0)
    # suppress image border peaks
    ys = torch.arange(H, device=response.device)[None, :, None]
    xs = torch.arange(W, device=response.device)[None, None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = torch.where(is_peak & inb, response, 0.0)
    top, idx = torch.topk(score.reshape(B, -1), k_max, dim=1)
    thr = rel_threshold * top.max(dim=1, keepdim=True).values
    valid = top > torch.clamp(thr, min=1e-6)
    xy = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)
    return xy, top, valid


def refine_corners_subpix(images, xy, win: int = 5, iters: int = 4):
    """cornerSubPix-equivalent saddle refinement.

    images: (B, H, W); xy: (B, K, 2) integer-ish seeds. Returns (B, K, 2)
    subpixel corners. Gaussian-weighted window recentered on the moving
    estimate each iteration, over fixed window pixels.

    Each corner reads one small contiguous window around its seed (one
    `extract_windows` call for the stack), computes gradients locally, and
    iterates entirely inside that window; the estimate can move at most
    iters * 1.5 px (the clipped step), so the window covers every reachable
    sample position.
    """
    B, H, W = images.shape
    dev = images.device
    imgs = images.to(torch.float32)
    # reach = window half-width + max total drift + bilinear support
    reach = win + int(np.ceil(iters * 1.5)) + 2
    WIN = 2 * reach + 2
    pad = reach + 1
    padded = F.pad(imgs[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0].contiguous()
    Hp, Wp = H + 2 * pad, W + 2 * pad

    # window top-left corners
    xi_all = torch.clamp(torch.round(xy[..., 0]).to(torch.int32) - WIN // 2 + pad, 0, Wp - WIN).contiguous()
    yi_all = torch.clamp(torch.round(xy[..., 1]).to(torch.int32) - WIN // 2 + pad, 0, Hp - WIN).contiguous()

    sub = extract_windows(padded, yi_all, xi_all, WIN).reshape(B * xy.shape[1], WIN, WIN)

    sigma2 = 2.0 * (win / 1.5) ** 2
    ar = torch.arange(WIN, dtype=torch.float32, device=dev)
    pxw = ar[None, :].expand(WIN, WIN).reshape(1, -1)
    pyw = ar[:, None].expand(WIN, WIN).reshape(1, -1)

    gx = torch.zeros_like(sub)
    gx[:, :, 1:-1] = (sub[:, :, 2:] - sub[:, :, :-2]) * 0.5
    gy = torch.zeros_like(sub)
    gy[:, 1:-1, :] = (sub[:, 2:, :] - sub[:, :-2, :]) * 0.5
    off = torch.stack([xi_all, yi_all], dim=-1).to(torch.float32).reshape(-1, 2) - pad  # window -> image coords
    # flat window pixels for the iteration
    gx = gx.reshape(gx.shape[0], -1)
    gy = gy.reshape(gy.shape[0], -1)
    gxx = gx * gx
    gxy = gx * gy
    gyy = gy * gy
    bx_w = gxx * pxw + gxy * pyw
    by_w = gxy * pxw + gyy * pyw

    c = xy.reshape(-1, 2).to(torch.float32) - off
    for _ in range(iters):
        # saddle condition over fixed window pixels with a gaussian
        # recentered on the moving estimate: no resampling, no gathers
        dx = pxw - c[:, 0:1]
        dy = pyw - c[:, 1:2]
        w = torch.exp(-(dx * dx + dy * dy) / sigma2)
        w = w * (torch.abs(dx) <= win + 0.5) * (torch.abs(dy) <= win + 0.5)
        a = (w * gxx).sum(dim=1)
        b = (w * gxy).sum(dim=1)
        cc = (w * gyy).sum(dim=1)
        bx = (w * bx_w).sum(dim=1)
        by = (w * by_w).sum(dim=1)
        det = a * cc - b * b
        safe = torch.abs(det) > 1e-9
        inv_det = 1.0 / torch.where(safe, det, 1.0)
        nx = (cc * bx - b * by) * inv_det
        ny = (a * by - b * bx) * inv_det
        new = torch.where(safe[:, None], torch.stack([nx, ny], dim=1), c)
        # bound the update to the window to avoid divergence on bad seeds
        c = c + torch.clamp(new - c, -1.5, 1.5)
    return (c + off).reshape(B, -1, 2)


def refine_corners_subpix_host(
    frames: "np.ndarray",
    xy: "np.ndarray",
    frame_ids: "np.ndarray",
    win: int = 5,
    iters: int = 4,
    relocalize: bool = False,
    relocal_range: int = 3,
):
    """Numpy mirror of refine_corners_subpix for HOST-side refinement.

    Used by the two-pass detection scheme (trackers/charuco_tracker.py,
    detect_scale 2 or 4): the device pipeline runs on downscaled frames,
    and the few hundred surviving corner candidates are polished at full
    resolution here, on windows sliced from the frames the host already
    holds. Same saddle iteration as the device path (fixed window,
    Gaussian recentered on the moving estimate).

    frames: (B, H, W) uint8/float; xy: (V, 2) full-res seeds; frame_ids:
    (V,) frame index per seed. Returns (V, 2) refined corners.
    """
    if len(xy) == 0:
        return xy.astype(np.float64)
    B, H, W = frames.shape
    reach = win + int(np.ceil(iters * 1.5)) + 2
    WIN = 2 * reach + 2
    pad = 0  # windows are clipped INSIDE the frame instead of edge-padding
    # (padding and float-converting the full stack would dwarf the
    # per-window math); candidates live >= 6 px from the border (NMS border
    # suppression), so a near-border window merely shifts off-center, which
    # the off-center-seed math handles anyway
    Hp, Wp = H, W
    xi = np.clip(np.round(xy[:, 0]).astype(np.int64) - WIN // 2, 0, Wp - WIN)
    yi = np.clip(np.round(xy[:, 1]).astype(np.int64) - WIN // 2, 0, Hp - WIN)
    ar = np.arange(WIN)
    sub = frames[frame_ids[:, None, None], yi[:, None, None] + ar[None, :, None], xi[:, None, None] + ar[None, None, :]].astype(np.float32)
    if relocalize:
        # Integer re-seed at the strongest full-res X-corner response
        # within +-3 px of the seed (a fast 8-point integer-ring port of
        # chess_corner_response): an approximate seed (e.g. scaled up from
        # a half-res detection, 2-3 px off) can sit in the wrong saddle
        # basin, and the saddle iteration then converges to a competing
        # structure. The search is confined to +-3 px — wider can land on
        # a NEIGHBORING grid corner in small-square footage, an error the
        # downstream gates (already passed) cannot catch.
        V = len(xy)
        rad = 4  # integer ring radius
        hr = int(relocal_range)  # relocal half-range (coarse-scale callers widen it)
        assert 2 * (rad + hr) + 1 <= WIN, "relocal_range exceeds the window reach"
        m = rad + hr  # patch margin around the search grid
        P15 = 2 * m + 1
        h = 2 * hr + 1
        # (V, P15, P15) patch centered on the integer seed, from `sub`
        sy = np.clip(np.round(xy[:, 1]).astype(np.int64) - yi - m, 0, WIN - P15)
        sx = np.clip(np.round(xy[:, 0]).astype(np.int64) - xi - m, 0, WIN - P15)
        ar15 = np.arange(P15)
        patch = sub[np.arange(V)[:, None, None], sy[:, None, None] + ar15[None, :, None], sx[:, None, None] + ar15[None, None, :]]
        offs8 = [(4, 0), (3, 3), (0, 4), (-3, 3), (-4, 0), (-3, -3), (0, -4), (3, -3)]
        rs = [patch[:, rad + oy : rad + oy + h, rad + ox : rad + ox + h] for ox, oy in offs8]
        ctr = patch[:, rad : rad + h, rad : rad + h]
        sr = sum(np.abs(rs[i] - rs[i + 4]) for i in range(4))
        dr = sum(np.abs(rs[i] - rs[(i + 2) % 8]) for i in range(4))
        mr = np.abs(sum(rs) / 8.0 - ctr) * 2.0
        resp = np.maximum(dr - sr - mr, 0.0)  # (V, h, h)
        flat = resp.reshape(V, -1)
        best = np.argmax(flat, axis=1)
        has_peak = flat[np.arange(V), best] > 0
        # patch-grid position -> window coords
        bx = (best % h) + sx + rad
        by = (best // h) + sy + rad
        # re-center each window on the relocated integer seed
        xi = np.where(has_peak, np.clip(xi + bx - WIN // 2, 0, Wp - WIN), xi)
        yi = np.where(has_peak, np.clip(yi + by - WIN // 2, 0, Hp - WIN), yi)
        xy = np.where(
            has_peak[:, None],
            np.stack([xi + WIN // 2 - pad, yi + WIN // 2 - pad], axis=1).astype(np.float64),
            xy,
        )
        sub = frames[frame_ids[:, None, None], yi[:, None, None] + ar[None, :, None], xi[:, None, None] + ar[None, None, :]].astype(np.float32)
    gx = np.zeros_like(sub)
    gy = np.zeros_like(sub)
    gx[:, :, 1:-1] = (sub[:, :, 2:] - sub[:, :, :-2]) * 0.5
    gy[:, 1:-1, :] = (sub[:, 2:, :] - sub[:, :-2, :]) * 0.5
    V = len(xy)
    # Per-window structure tensors, kept (V, WIN, WIN): the Gaussian-x-box
    # weight is SEPARABLE (w = wy(row) * wx(col)), so each weighted sum
    # collapses to two small contractions — stats @ wx then · wy — instead
    # of materializing the (V, WIN^2) weight plane and paying a dense exp
    # per pixel per iteration (~14x fewer exps).
    gxx = gx * gx
    gxy = gx * gy
    gyy = gy * gy
    arf = ar.astype(np.float32)
    bx_w = gxx * arf[None, None, :] + gxy * arf[None, :, None]
    by_w = gxy * arf[None, None, :] + gyy * arf[None, :, None]
    stats = np.stack([gxx, gxy, gyy, bx_w, by_w], axis=1)  # (V, 5, WIN, WIN)
    sigma2 = 2.0 * (win / 1.5) ** 2
    # f32 iteration (the f64 default doubled the numpy traffic and exp
    # cost for no accuracy the 1e-2-px-scale saddle can use)
    off = np.stack([xi, yi], axis=1).astype(np.float32) - pad  # window -> image
    c = xy.astype(np.float32) - off  # (V,2) in window coords
    for _ in range(iters):
        dx = arf[None, :] - c[:, 0:1]  # (V, WIN)
        dy = arf[None, :] - c[:, 1:2]
        wx = np.exp(-dx * dx / sigma2) * (np.abs(dx) <= win + 0.5)
        wy = np.exp(-dy * dy / sigma2) * (np.abs(dy) <= win + 0.5)
        # (V, 5, WIN, WIN) @ (V, 1, WIN, 1) -> (V, 5, WIN); then · wy -> (V, 5)
        col = stats @ wx[:, None, :, None]
        a, b, cc, bx, by = np.einsum("vkr,vr->kv", col[..., 0], wy, optimize=True)
        det = a * cc - b * b
        safe = np.abs(det) > 1e-9
        inv_det = 1.0 / np.where(safe, det, 1.0)
        nx = (cc * bx - b * by) * inv_det
        ny = (a * by - b * bx) * inv_det
        new = np.where(safe[:, None], np.stack([nx, ny], axis=1), c)
        c = c + np.clip(new - c, -1.5, 1.5)
    return (c + off).astype(np.float64)


def xcorner_graph(imgs, k_max: int):
    """The X-corner graph (response -> NMS -> saddle subpixel) on (B, H, W)
    float32 frames already on their device; composable into the ChArUco
    tracker's device program. The response is the kernel's function
    (cuda_kernels.corner_response) on either device."""
    resp = corner_response(imgs)
    xy, score, valid = nms_corners(resp, k_max)
    xy = refine_corners_subpix(imgs, xy)
    return xy, score, valid


def detect_x_corners_device(images, k_max: int, device=None):
    """Full device program: response -> NMS -> subpixel. (B, H, W) frames
    (numpy or tensor) in, tensors (xy (B, K, 2), score (B, K), valid (B, K))
    on the device out. Runs on the CUDA device unless `device` names
    another; raises without one."""
    dev = resolve_device(device)
    imgs = torch.as_tensor(np.ascontiguousarray(images) if isinstance(images, np.ndarray) else images)
    return xcorner_graph(imgs.to(dev).to(torch.float32).contiguous(), k_max)
