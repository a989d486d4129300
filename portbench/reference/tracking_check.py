"""What decides `correct` for tracked frames: each reported corner against
the renderer's exact projection of the corner its id names.

- `pos_err_max_px`: the largest distance from a reported corner to the
  exact image position of its id (corners whose id is in the frame);
- `stray`: corners reported whose id is not in the frame (the board not
  drawn there, or that corner outside the image), or reported twice;
- `err_p90_px`: the 90th percentile, over every corner in the frame where
  the board is drawn, of the distance from the corner reported for it to
  its exact position, a corner not reported counting as infinitely far
  (a tenth of the corners may be missed; a frame left out fails it).

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def corner_numbers(cam, frame, kp, uv, truth, visible):
    """Numbers of the detections (cam, frame, kp (M,) and uv (M, 2)) against
    truth (C, F, N, 2) and visible (C, F, N)."""
    cam, frame, kp = (np.asarray(a, np.int64) for a in (cam, frame, kp))
    C, F, N = visible.shape
    key = (cam * F + frame) * N + kp
    uniq, counts = np.unique(key, return_counts=True)
    seen = visible.reshape(-1)[key]
    err = np.linalg.norm(np.asarray(uv, float) - truth.reshape(-1, 2)[key], axis=1)
    stray = int((~seen).sum() + (counts - 1).sum())
    per_corner = np.full(C * F * N, np.inf)
    per_corner[key[seen]] = err[seen]
    in_frame = per_corner[visible.reshape(-1)]
    return {
        "pos_err_max_px": float(err[seen].max()) if seen.any() else float("nan"),
        "stray": float(stray),
        "err_p90_px": float(np.quantile(in_frame, 0.9, method="inverted_cdf")) if len(in_frame) else float("nan"),
    }


def bf16(x):
    """`x` rounded to the nearest bfloat16 (ties to even), as float64."""
    a = np.asarray(x, np.float64).astype(np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def control_numbers(truth, visible):
    """The control: the reference (the exact projections) put in the
    program's place in bfloat16, every corner in the frame reported."""
    C, F, N = visible.shape
    c, f, k = np.nonzero(visible)
    return corner_numbers(c, f, k, bf16(truth[c, f, k]), truth, visible)
