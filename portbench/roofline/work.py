"""Operations and bytes the hand-written kernels must do and move, from
their shapes: each input byte read once, each output byte written once.
Frozen copies of the arithmetic of chip_smoke.py (`schur_work`,
`response_ops_per_pixel`, the labeling and window byte counts) and the
published peaks (peaks.json), so a kernel's roofline share is
least time / device time, the least time the larger of bytes over the
memory rate and operations over the compute rate."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads(Path(__file__).with_name("peaks.json").read_text())

# the ring response: 16 bilinear samples (78 operations for the ring's
# tap weights, a term of weight 0 costing nothing and one of weight 1 no
# product), 32 for the sums and differences, 17 for the mean, 6 for the
# rest: 133 float32 instructions a pixel, none of which may fuse into an FMA
RESPONSE_OPS_PER_PIXEL = 133


def peaks(device_name):
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r} in peaks.json")
    return PEAKS[device_name]


def ccl(B, H, W, n_iters):
    """(bytes, ops, rate key) of labeling a (B, H, W) mask: the mask read
    (1 B a pixel) and the labels written (4 B); two min-or-keep steps a
    pixel and round, at the float32 lanes' rate."""
    return B * H * W * 5, B * H * W * 2 * n_iters, "fp32_flops_per_s"


def corner_response(B, H, W):
    """(bytes, ops, rate key) of the ring response of (B, H, W) float32."""
    return B * H * W * 8, B * H * W * RESPONSE_OPS_PER_PIXEL, "fp32_instructions_per_s"


def extract_windows(B, K, win, itemsize=4):
    """(bytes, ops, rate key) of gathering K win x win windows a frame:
    each window read and written once, and the two int32 seeds."""
    return B * K * (2 * itemsize * win * win + 8), 0, "fp32_flops_per_s"


def schur_s_rhs(C, P):
    """(bytes, ops, rate key) of the Schur system of C cameras and P points:
    each input read once, each output written once; products and sums of
    G, Y, S (upper triangle), rhs and the point inverses."""
    n_cp = 9 * C
    bytes_ = 4 * (C * 2 * 9 * P + C * 2 * 3 * P + C * 2 * P + 3 * P + 1 + n_cp * n_cp + n_cp + 9 * P)
    ops = P * (C * 2 * 15 + 40 + n_cp * 2 * (1 + 3 * 2) + 3 * n_cp * 3 * 2 + 3 * n_cp * (n_cp + 1) + 3 * n_cp * 2)
    return bytes_, ops, "fp32_flops_per_s"


def least_seconds(work, device_name):
    bytes_, ops, rate = work
    p = peaks(device_name)
    return max(bytes_ / p["hbm_bytes_per_s"], ops / p[rate] if ops else 0.0)


def roofline_share(calls, kernel_seconds, device_name):
    """Percent: the least time of the `calls` (work tuples) over the device
    time their kernels took; None when there is nothing to read."""
    if not calls or kernel_seconds <= 0:
        return None
    return 100.0 * sum(least_seconds(w, device_name) for w in calls) / kernel_seconds
