"""What the ring-response and window-gather CUDA kernels
(caliscope_tpu_torch/csrc/corner_response.cu, extract_windows.cu) compute,
modelled in torch and numpy on the CPU, where no kernel runs.

- Ring response: the kernel forms each tap's vertical blend once per column
  and shares it between neighbouring outputs, drops the terms whose weight
  is exactly 0.0f and forms no product with a weight of exactly 1.0f, and
  folds the samples into its sums in the plain version's order. A torch
  model of that order is torch.equal to corner_response_plain, zero-valued
  regions (of either sign) included; the taps compiled into the kernel are
  ring_taps() to the bit, and each reaches only the rows of its phase and
  the columns of a run.
- Window gather: the kernel's partition of the seeds over blocks (one block
  a seed, its threads walking the window's words) writes every word once
  and gives extract_windows_plain's windows, for odd K and windows whose
  words leave the block's last pass partial.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from caliscope_tpu_torch.detect import cuda_kernels as CK
from torch_detect_common import t

N = CK.N_TAPS
RUN = 4  # outputs a thread computes along x (csrc/corner_response.cu: RUN)
REACH = 4  # halo the kernel stages (REACH)
PHASE_A = 9  # taps 0..8 read rows 0..4, taps 9..15 rows -4..-1 (PHASE_A)


def _rows_and_columns(k):
    """Rows (relative to the output) and blended columns j (column x + ix +
    j) tap k reads once its zero-weight terms are dropped."""
    (iy, ix), (wy0, wy1, wx0, wx1) = CK.ring_taps()[0][k], CK.ring_taps()[1][k]
    rows = [d for d, w in ((iy, wy0), (iy + 1, wy1)) if w != 0]
    cols = [j for j, w in ((0, wx0), (1, wx1)) if w != 0]
    return rows, cols, int(ix)


def response_model(images):
    """The kernel's order of operations over whole frames: per tap, the
    vertical blend of every column once (rows ascending), then the
    horizontal blend of neighbouring columns; exact 0.0 weights drop their
    term, exact 1.0 weights form no product; sums from +0 in index order;
    the mean as sum * 0.0625 (the same rounding as sum / 16)."""
    B, H, W = images.shape
    pad = CK.PAD
    out = torch.zeros_like(images)
    Hi, Wi = H - 2 * pad, W - 2 * pad
    if Hi <= 0 or Wi <= 0:
        return out
    offsets, weights = CK.ring_taps()

    def weighted(w, a):
        return a if w == 1.0 else float(w) * a

    s = []
    for (iy, ix), (wy0, wy1, wx0, wx1) in zip(offsets.tolist(), weights.tolist()):
        v = None  # vertical blend over the full width, rows of the interior
        for dy, w in ((iy, wy0), (iy + 1, wy1)):
            if w != 0.0:
                term = weighted(w, images[:, pad + dy : pad + dy + Hi, :])
                v = term if v is None else v + term
        h = [weighted(w, v[:, :, pad + ix + j : pad + ix + j + Wi]) for j, w in ((0, wx0), (1, wx1)) if w != 0.0]
        s.append(h[0] if len(h) == 1 else h[0] + h[1])
    zero = torch.zeros_like(s[0])
    total, sr, dr = zero, zero, zero
    for i in range(N):
        total = total + s[i]
    for i in range(N // 2):
        dr = dr + torch.abs(s[i] - s[i + N // 4])
        sr = sr + torch.abs(s[i] - s[i + N // 2])
    center = images[:, pad : pad + Hi, pad : pad + Wi]
    mr = torch.abs(total * (1.0 / N) - center) * float(N // 2) * 0.5
    out[:, pad : H - pad, pad : W - pad] = torch.clamp(dr - sr - mr, min=0.0)
    return out


def _frames(case, rng):
    if case == "random":
        return rng.uniform(0, 255, size=(2, 72, 136)).astype(np.float32)
    if case == "ragged":
        return rng.uniform(0, 255, size=(2, 97, 131)).astype(np.float32)
    if case == "signed_zeros":
        # regions of +0 and -0 next to each other and to values of both
        # signs: where a dropped 0 * x could only have changed a zero's sign
        x = rng.normal(scale=50.0, size=(2, 80, 96)).astype(np.float32)
        x[:, 10:40, 10:50] = 0.0
        x[:, 30:70, 40:80] = -0.0
        x[:, ::9, :] = 0.0
        x[1, :, ::5] = -0.0
        return x
    if case == "sparse":
        # mostly zeros with single bright pixels: the near-zero weights
        # (~1e-16) times a bright pixel are the only non-zero terms
        x = np.zeros((1, 64, 64), np.float32)
        x[0, rng.integers(0, 64, 40), rng.integers(0, 64, 40)] = rng.uniform(1, 255, 40).astype(np.float32)
        return x
    if case == "one_interior_pixel":
        return rng.uniform(0, 255, size=(1, 2 * CK.PAD + 1, 2 * CK.PAD + 1)).astype(np.float32)
    return rng.uniform(0, 255, size=(1, 10, 40)).astype(np.float32)  # no interior at all


@pytest.mark.parametrize("case", ["random", "ragged", "signed_zeros", "sparse", "one_interior_pixel", "smaller_than_border"])
def test_response_operation_order_is_bit_equal_to_plain(rng, case):
    x = t(_frames(case, rng))
    got, want = response_model(x), CK.corner_response_plain(x)
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # zeros' signs too


def test_response_taps_drop_only_exact_zeros_and_ones():
    _, weights = CK.ring_taps()
    zeros = {(k, c) for k in range(N) for c in range(4) if weights[k, c] == 0.0}
    ones = {(k, c) for k in range(N) for c in range(4) if weights[k, c] == 1.0}
    # [wy0, wy1, wx0, wx1]: taps 0, 4, 8, 12 lie on the axes
    assert zeros == {(0, 1), (0, 3), (4, 1), (8, 3), (12, 1)}
    assert ones == {(0, 0), (0, 2), (4, 0), (4, 2), (8, 0), (8, 2), (12, 0), (12, 3)}
    tiny = weights[(weights > 0) & (weights < 1e-6)]
    assert len(tiny) == 3 and (tiny > 1e-17).all()  # kept: 2.4e-16, 4.9e-16, 7.8e-16


def test_response_taps_fit_the_kernels_phases_and_runs():
    for k in range(N):
        rows, cols, ix = _rows_and_columns(k)
        assert rows and cols
        assert (0 <= min(rows) and max(rows) <= REACH) if k < PHASE_A else (-REACH <= min(rows) and max(rows) <= -1)
        # columns x0 + ix + j, j in [min(cols), max(cols) + RUN - 1], of the
        # run's segment x0 - 4 .. x0 + RUN + 3
        assert 0 <= ix + min(cols) + REACH and ix + max(cols) + RUN - 1 + REACH < RUN + 2 * REACH


def test_kernel_tap_table_is_ring_taps_to_the_bit():
    src = (Path(CK.__file__).resolve().parents[1] / "csrc" / "corner_response.cu").read_text()
    rows = re.findall(r"case \d+: return \{([^}]*)\};|default: return \{([^}]*)\};", src)
    table = [next(r for r in row if r) for row in rows]
    assert len(table) == N
    offsets, weights = CK.ring_taps()
    for k, entry in enumerate(table):
        fields = [f.strip() for f in entry.split(",")]
        assert [int(fields[0]), int(fields[1])] == offsets[k].tolist()
        got = np.array([float.fromhex(f.rstrip("f")) for f in fields[2:]], np.float32)
        assert got.tobytes() == weights[k].tobytes(), k


# ---------------------------------------------------------------------------
# window gather
# ---------------------------------------------------------------------------


THREADS = 256  # a window-gather block's threads (csrc/extract_windows.cu: THREADS)


def windows_model(frames, yi, xi, win):
    """The kernel's loops, block after block: block (k, b) copies seed k of
    frame b, its threads walking the window's words row-major (idx = thread,
    thread + THREADS, ...; row idx // win, column idx % win). Returns
    (windows (B, K, win, win), times each output word was written)."""
    B, Hp, Wp = frames.shape
    K = yi.shape[1]
    out = np.zeros((B * K, win * win), frames.dtype)
    written = np.zeros((B * K, win * win), np.int64)
    for b in range(B):
        for k in range(K):
            seed = b * K + k
            y = min(max(int(yi[b, k]), 0), Hp - win)
            x = min(max(int(xi[b, k]), 0), Wp - win)
            for thread in range(THREADS):
                idx = np.arange(thread, win * win, THREADS)
                r, c = idx // win, idx % win
                out[seed, idx] = frames[b, y + r, x + c]
                written[seed, idx] += 1
    return out.reshape(B, K, win, win), written


WINDOW_MODEL_CASES = {
    # (B, Hp, Wp, K, win): K odd, windows of win * win words that leave the
    # block's last pass partial (784 = 3 * 256 + 16), or shorter than one pass
    "k37_win28": (2, 60, 70, 37, 28),
    "k5_win96": (3, 120, 130, 5, 96),
    "k3_win17": (1, 40, 50, 3, 17),
    "k7_win1": (2, 9, 11, 7, 1),
}


@pytest.mark.parametrize("case", list(WINDOW_MODEL_CASES))
def test_window_partition_writes_each_word_once(rng, case):
    B, Hp, Wp, K, win = WINDOW_MODEL_CASES[case]
    frames = rng.integers(-(2**31), 2**31 - 1, size=(B, Hp, Wp)).astype(np.int32)
    yi = rng.integers(-5, Hp + 5, size=(B, K)).astype(np.int32)  # some outside: clamped
    xi = rng.integers(-5, Wp + 5, size=(B, K)).astype(np.int32)
    got, written = windows_model(frames, yi, xi, win)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, CK.extract_windows_plain(t(frames), t(yi), t(xi), win).numpy())
