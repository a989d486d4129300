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
- Window gather: the kernel's two partitions write every word once and
  give extract_windows_plain's windows, for odd K, small and large windows
  and rings that wrap many times. TMA path: persistent blocks over the
  seeds, one thread keeping `stages` loads of boxes that start on 16-byte
  boundaries in flight, the block's threads packing each window, each
  packed window stored whole, the packed buffer reused only after its
  store was read, the seeds fetched 32 at a time a chunk ahead. Rows path: a warp a window row at a
  time, several windows a block when they are small. The model's constants
  are read from csrc/extract_windows.cu, and the wrapper's path rule's
  from the same place.
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


def _cu_constants():
    """The `constexpr int` constants of csrc/extract_windows.cu, by name."""
    src = (Path(CK.__file__).resolve().parents[1] / "csrc" / "extract_windows.cu").read_text()
    found = re.findall(r"constexpr int (\w+) = ([0-9 *]+);", src)
    return {name: int(np.prod([int(f) for f in value.split("*")])) for name, value in found}


CU = _cu_constants()


def _clamped(frames, yi, xi, win, s):
    """(b, y, x) of seed s = b * K + k, clamped as the kernel clamps."""
    B, Hp, Wp = frames.shape
    K = yi.shape[1]
    b, k = divmod(s, K)
    return b, min(max(int(yi[b, k]), 0), Hp - win), min(max(int(xi[b, k]), 0), Wp - win)


def tma_model(frames, yi, xi, win, stages, slots):
    """The TMA path's loops with `slots` blocks resident at once (the
    occupancy's blocks an SM times the SMs), block after block, with its
    buffers: a load lands a box of win + PAD columns starting at x rounded
    down to 4 words (TMA zero-fills columns past the frame) in stage j %
    stages, which completes that stage's next phase; item i waits for phase
    i // stages of its stage, the block's threads pack its window from the
    tile at the tile's shift into the packed buffer once the previous store
    has read it (cp.async.bulk.wait_group.read 0), each thread walking
    (row, column) by (threads // win, threads % win), and one thread stores
    the packed window whole; then load i + stages refills the stage. The
    seeds' coordinates come from the first warp's two chunks of 32,
    refreshed as the kernel does. Returns (windows (B, K, win, win), times
    each output word was written)."""
    B, Hp, Wp = frames.shape
    n_seeds = B * yi.shape[1]
    box_w = win + CU["PAD"]
    G = min(n_seeds, slots)
    threads = CU["TMA_THREADS"]
    padded = np.zeros((B, Hp, Wp + box_w), frames.dtype)  # TMA's zero fill past the frame
    padded[:, :, :Wp] = frames
    out = np.zeros((n_seeds, win * win), frames.dtype)
    written = np.zeros((n_seeds, win * win), np.int64)
    for g in range(G):
        n = (n_seeds - 1 - g) // G + 1
        ring, phases, shift = [None] * stages, [0] * stages, [0] * stages
        store_reading = False  # the last store may still read the packed buffer

        def chunk(c):
            return [_clamped(frames, yi, xi, win, g + i * G) if i < n else None for i in range(32 * c, 32 * c + 32)]

        cur, nxt = chunk(0), chunk(1)
        j = 0

        def load():
            nonlocal cur, nxt, j
            if j > 0 and j % 32 == 0:
                cur, nxt = nxt, chunk(j // 32 + 1)
            b, y, x = cur[j % 32]
            st = j % stages
            x0 = x & ~3  # a box on a 16-byte boundary
            shift[st] = x - x0
            ring[st] = (j, padded[b, y : y + win, x0 : x0 + box_w].copy())
            phases[st] += 1
            j += 1

        while j < min(n, stages):
            load()
        for i in range(n):
            st = i % stages
            assert phases[st] == i // stages + 1  # the awaited phase landed, no later one
            store_reading = False  # wait_group.read 0
            item, tile = ring[st]
            assert item == i
            packed = np.zeros(win * win, frames.dtype)
            counts = np.zeros(win * win, np.int64)
            for tid in range(threads):
                r, c = divmod(tid, win)
                for o in range(tid, win * win, threads):
                    assert not store_reading
                    packed[o] = tile[r, shift[st] + c]
                    counts[o] += 1
                    r, c = r + threads // win, c + threads % win
                    if c >= win:
                        r, c = r + 1, c - win
            assert (counts == 1).all()
            s = g + i * G
            out[s] = packed
            written[s] += 1
            store_reading = True
            if j < n:
                load()
    return out.reshape(B, -1, win, win), written


def rows_model(frames, yi, xi, win):
    """The rows path's loops: block after block, warp after warp, the warp's
    (window, row) walked from row index `warp` in steps of its block's warps
    with no division, lane after lane over the row's words."""
    B, Hp, Wp = frames.shape
    n_seeds = B * yi.shape[1]
    per_block = max(1, CU["ROWS_PER_BLOCK"] // win)
    warps = CU["ROW_THREADS"] // 32
    out = np.zeros((n_seeds, win * win), frames.dtype)
    written = np.zeros((n_seeds, win * win), np.int64)
    for block in range(-(-n_seeds // per_block)):
        first = block * per_block
        windows = min(per_block, n_seeds - first)
        for warp in range(warps):
            w, r = 0, warp
            while r >= win:
                r, w = r - win, w + 1
            while w < windows:
                b, y, x = _clamped(frames, yi, xi, win, first + w)
                for lane in range(32):
                    c = np.arange(lane, win, 32)
                    out[first + w, r * win + c] = frames[b, y + r, x + c]
                    written[first + w, r * win + c] += 1
                r += warps
                while r >= win:
                    r, w = r - win, w + 1
    return out.reshape(B, -1, win, win), written


def windows_model(frames, yi, xi, win, slots):
    """The path the wrapper's rule picks for these frames, modelled."""
    stages = CK.tma_stages(frames.shape[2], win, t(frames).data_ptr())
    if stages:
        return "tma", *tma_model(frames, yi, xi, win, stages, slots)
    return "rows", *rows_model(frames, yi, xi, win)


WINDOW_MODEL_CASES = {
    # (B, Hp, Wp, K, win, TMA blocks resident at once), and the path the
    # rule picks. Rows: K odd, windows of 784 words, windows wider than a
    # warp (96), shorter than one (17), of one word, several a block
    "k37_win28": ((2, 60, 70, 37, 28, 1056), "rows"),
    "k5_win96": ((3, 120, 130, 5, 96, 264), "rows"),
    "k3_win17": ((1, 40, 50, 3, 17, 1056), "rows"),
    "k7_win1": ((2, 9, 11, 7, 1, 1056), "rows"),
    # TMA: a block a seed (the H100's 132 SMs x 8); several seeds a block;
    # large windows, two a block; one stage reused; the stages reused many
    # times, the seeds' chunks refilled; the smallest window
    "k37_win28_tma": ((2, 60, 72, 37, 28, 1056), "tma"),
    "k37_win28_tma_8_blocks": ((2, 60, 72, 37, 28, 8), "tma"),
    "k9_win96_tma": ((3, 120, 132, 9, 96, 2), "tma"),
    "k5_win116_tma_one_stage": ((1, 120, 124, 5, 116, 1), "tma"),
    "k300_win28_tma_chunks": ((2, 60, 72, 300, 28, 3), "tma"),
    "k7_win4_tma": ((2, 9, 12, 7, 4, 2), "tma"),
}


@pytest.mark.parametrize("case", list(WINDOW_MODEL_CASES))
def test_window_partition_writes_each_word_once(rng, case):
    (B, Hp, Wp, K, win, slots), path = WINDOW_MODEL_CASES[case]
    frames = rng.integers(-(2**31), 2**31 - 1, size=(B, Hp, Wp)).astype(np.int32)
    yi = rng.integers(-5, Hp + 5, size=(B, K)).astype(np.int32)  # some outside: clamped
    xi = rng.integers(-5, Wp + 5, size=(B, K)).astype(np.int32)
    got_path, got, written = windows_model(frames, yi, xi, win, slots)
    assert got_path == path
    assert (written == 1).all()
    np.testing.assert_array_equal(got, CK.extract_windows_plain(t(frames), t(yi), t(xi), win).numpy())


def test_window_constants_are_the_kernels():
    assert (CK.TMA_MAX_STAGES, CK.TMA_RING_BYTES, CK.TMA_STAGE_ALIGN, CK.TMA_MAX_BOX, CK.TMA_PAD) == (
        CU["MAX_STAGES"], CU["RING_BYTES"], CU["STAGE_ALIGN"], CU["MAX_BOX"], CU["PAD"])
    aligned = lambda nbytes: -(-nbytes // CU["STAGE_ALIGN"]) * CU["STAGE_ALIGN"]  # noqa: E731
    for win in range(4, CK.TMA_MAX_BOX + 1, 4):
        stages = CK.tma_stages(1280, win, 0)
        tile, free = aligned(4 * (win + CU["PAD"]) * win), CU["RING_BYTES"] - aligned(4 * win * win)
        if stages:  # 1..MAX_STAGES stages that fit beside the packed window
            assert 1 <= stages <= CU["MAX_STAGES"] and stages * tile <= free
            assert stages == CU["MAX_STAGES"] or (stages + 1) * tile > free
        else:
            assert tile > free
    assert CK.tma_stages(1280, 96, 0) == 2 and CK.tma_stages(1280, 116, 0) == 1 and CK.tma_stages(1280, 120, 0) == 0
    assert CK.tma_stages(1308, 28, 0) == 2 and CK.tma_stages(1308, 28, 8) == 0  # an unaligned base
    assert CK.tma_stages(32, 28, 0) == 2 and CK.tma_stages(28, 28, 0) == 0  # the box lies within the frame
