"""Butterworth low-pass design + zero-phase IIR filtering on torch tensors.

Port of caliscope_tpu/ops/signal.py (scipy.signal.butter / lfilter /
lfilter_zi / filtfilt semantics, odd-extension padding). Coefficient design
is host-side closed-form math.

The JAX package runs the filter as a `lax.scan` over time. Eagerly on a
device a step-by-step recurrence would be a handful of launches per sample,
so here the IIR is solved in closed form: the difference equation
sum_i a_i y[t-i] = sum_i b_i x[t-i] (+ the initial state on the first
n-1 samples) is a banded lower-triangular Toeplitz system in y, solved by
`torch.linalg.solve_triangular` over blocks of BLOCK samples (the history of
the previous block moved to the right-hand side), every column of x (every
coordinate of every track of one length) at once. It is exact (the same
equations, summed in another order), costs O(T * BLOCK) memory, and launches
a few kernels per block instead of per sample.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1024


def butter_lowpass(cutoff_hz: float, fs: float, order: int = 2):
    """Digital Butterworth low-pass (b, a) via bilinear transform.

    Equivalent to scipy.signal.butter(order, cutoff/(fs/2), 'low').
    """
    wn = cutoff_hz / (fs / 2.0)
    if not 0 < wn < 1:
        raise ValueError(f"Normalized cutoff {wn} must be in (0, 1)")
    # Analog prototype poles (Butterworth, unit cutoff), pre-warped
    k = np.arange(1, order + 1)
    poles = np.exp(1j * np.pi * (2 * k + order - 1) / (2 * order))
    warped = 4.0 * np.tan(np.pi * wn / 2.0)
    poles = poles * warped
    # Bilinear transform with fs = 2 (scipy convention): z = (4 + s)/(4 - s).
    z_poles = (4.0 + poles) / (4.0 - poles)
    a = np.real(np.poly(z_poles))
    # All-pole analog lowpass maps to `order` zeros at z = -1; the gain is
    # fixed by unity DC response (H(1) = 1), exact for a lowpass.
    b = np.real(np.poly(-np.ones(order)))
    b = b * (np.sum(a) / np.sum(b))
    return b.astype(np.float64), a.astype(np.float64)


def _normalized(b, a):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64) / a[0]
    a = a / a[0]
    n = max(len(a), len(b))
    return np.pad(b, (0, n - len(b))), np.pad(a, (0, n - len(a))), n


def _toeplitz_lower(c: np.ndarray, size: int, like: torch.Tensor) -> torch.Tensor:
    """(size, size) lower-triangular banded Toeplitz matrix, c[i] on the
    i-th subdiagonal."""
    i = torch.arange(size, device=like.device)
    lag = i[:, None] - i[None, :]
    m = torch.zeros((size, size), dtype=like.dtype, device=like.device)
    for k, v in enumerate(c):
        m = torch.where(lag == k, torch.as_tensor(float(v), dtype=like.dtype, device=like.device), m)
    return m


def lfilter(b, a, x, zi=None):
    """Direct-form II transposed IIR filter along axis 0, as scipy's and the
    JAX package's lfilter. x: (T,) or (T, D) tensor; zi: (n-1, D)."""
    b, a, n = _normalized(b, a)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    T, D = x.shape
    # right-hand side: sum_i b_i x[t-i], plus the initial state on t < n-1
    xpad = torch.cat([torch.zeros((n - 1, D), dtype=x.dtype, device=x.device), x])
    rhs = sum(float(b[i]) * xpad[n - 1 - i : n - 1 - i + T] for i in range(n))
    if zi is not None:
        m = min(n - 1, T)
        rhs = torch.cat([rhs[:m] + torch.as_tensor(zi, dtype=x.dtype, device=x.device)[:m], rhs[m:]])
    L = min(T, BLOCK)
    A = _toeplitz_lower(a, L, x)
    # y rows of the previous block that reach row r of this one: a_i for
    # i > r, at lag i - r - 1 from the block's start
    hist = np.zeros((n - 1, n - 1))
    for r in range(n - 1):
        for i in range(r + 1, n):
            hist[r, n - 1 - (i - r)] = a[i]
    H = torch.as_tensor(hist, dtype=x.dtype, device=x.device)
    out, prev = [], torch.zeros((n - 1, D), dtype=x.dtype, device=x.device)
    for s in range(0, T, L):
        r = rhs[s : s + L]
        k = min(n - 1, r.shape[0])
        r = torch.cat([r[:k] - (H @ prev)[:k], r[k:]])
        A_blk = A if r.shape[0] == L else A[: r.shape[0], : r.shape[0]]
        y = torch.linalg.solve_triangular(A_blk, r, upper=False, unitriangular=True)
        out.append(y)
        prev = torch.cat([prev, y])[-(n - 1):] if n > 1 else prev
    y = torch.cat(out)
    return y[:, 0] if squeeze else y


def _lfilter_zi(b, a):
    """Steady-state initial conditions (scipy.signal.lfilter_zi equivalent)."""
    b, a, n = _normalized(b, a)
    # companion(a).T: first column -a[1:], ones on the superdiagonal
    comp_t = np.zeros((n - 1, n - 1))
    comp_t[:, 0] = -a[1:]
    comp_t[: n - 2, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - comp_t, B)


def filtfilt(b, a, x, axis: int = 0):
    """Zero-phase filtering with odd-extension padding (scipy-compatible).

    x: (T,) or (T, D) tensor filtered along `axis`.
    """
    if axis != 0:
        x = torch.movedim(x, axis, 0)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    ntaps = max(len(np.atleast_1d(a)), len(np.atleast_1d(b)))
    padlen = 3 * ntaps
    if x.shape[0] <= padlen:
        raise ValueError(f"Input length {x.shape[0]} must exceed padlen {padlen}")
    # Odd extension at both ends
    front = 2 * x[0] - torch.flip(x[1 : padlen + 1], dims=[0])
    back = 2 * x[-1] - torch.flip(x[-padlen - 1 : -1], dims=[0])
    ext = torch.cat([front, x, back])
    zi = torch.as_tensor(_lfilter_zi(b, a), dtype=x.dtype, device=x.device)[:, None]
    y = lfilter(b, a, ext, zi * ext[0])
    y = torch.flip(lfilter(b, a, torch.flip(y, dims=[0]), zi * y[-1]), dims=[0])
    y = y[padlen:-padlen]
    if squeeze:
        y = y[:, 0]
    if axis != 0:
        y = torch.movedim(y, 0, axis)
    return y
