"""The resident labeling path of the port (caliscope_tpu_torch.detect.ccl,
csrc/ccl.cu::ccl_resident): its algorithm and its plan, on the CPU.

The CUDA kernel keeps a frame in the shared memory of a thread-block
cluster, cut into bands of rows (one per block), and a row into chunks of
256 pixels. Both passes of a round are the same three steps over the pieces
of a line: (a) run minima inside each piece, and a flag "foreground
throughout"; (b) for the runs that cross a piece's two edges, the minimum
gathered from the neighbouring pieces' edge pixels, walking on while the
pieces are linked and foreground throughout; (c) the edge-touching runs
take those minima. `model_labels` below is that algorithm in torch, with
(b) computed for every piece before any (c), as the kernel's barriers
order it. It must equal detect/kernels.py::connected_components and the
interpreted Pallas kernel bit for bit after exactly n_iters rounds (integer
minima: no tolerance). The kernel itself is held to the plain version on
the card by chip_smoke.py and by the `cuda`-marked tests at the end, which
skip without a GPU.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from caliscope_tpu.detect.pallas_ccl import connected_components_pallas
from caliscope_tpu_torch.detect import ccl as TC
from caliscope_tpu_torch.detect import kernels as DK

# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _runs_inside(seg, bg):
    """Every run of entries != bg along the last axis takes its minimum."""
    n = seg.shape[-1]
    for i in range(1, n):
        link = (seg[:, i] != bg) & (seg[:, i - 1] != bg)
        seg[:, i] = torch.where(link, torch.minimum(seg[:, i], seg[:, i - 1]), seg[:, i])
    for i in range(n - 2, -1, -1):
        link = (seg[:, i] != bg) & (seg[:, i + 1] != bg)
        seg[:, i] = torch.where(link, torch.minimum(seg[:, i], seg[:, i + 1]), seg[:, i])


def _piece_pass(lines, bounds, bg):
    """One pass over `lines` (N, n) cut into the pieces `bounds` (a list of
    (start, stop); trailing pieces may be empty), in place."""
    pieces = [b for b in bounds if b[1] > b[0]]
    for s, e in pieces:  # (a)
        _runs_inside(lines[:, s:e], bg)
    fg = lines != bg
    full = [fg[:, s:e].all(dim=1) for s, e in pieces]
    first = [lines[:, s].clone() for s, _ in pieces]
    last = [lines[:, e - 1].clone() for _, e in pieces]
    none = torch.full_like(first[0], bg)
    minima = []
    for r in range(len(pieces)):  # (b), all of it before any of (c)
        crosses_near = (first[r] != bg) & (last[r - 1] != bg) if r > 0 else torch.zeros_like(full[0])
        crosses_far = (last[r] != bg) & (first[r + 1] != bg) if r + 1 < len(pieces) else torch.zeros_like(full[0])
        lo, alive = none.clone(), crosses_near.clone()
        for j in range(r - 1, -1, -1):
            lo = torch.where(alive, torch.minimum(lo, last[j]), lo)
            alive = alive & full[j] & ((last[j - 1] != bg) if j > 0 else False)
        hi, alive = none.clone(), crosses_far.clone()
        for j in range(r + 1, len(pieces)):
            hi = torch.where(alive, torch.minimum(hi, first[j]), hi)
            alive = alive & full[j] & ((first[j + 1] != bg) if j + 1 < len(pieces) else False)
        m_near = torch.where(crosses_near, torch.minimum(lo, torch.where(full[r] & crosses_far, hi, none)), none)
        m_far = torch.where(crosses_far, torch.minimum(hi, torch.where(full[r] & crosses_near, lo, none)), none)
        minima.append((m_near, m_far))
    for (s, e), (m_near, m_far) in zip(pieces, minima):  # (c)
        seg, seg_fg = lines[:, s:e], fg[:, s:e]
        leading = torch.cumprod(seg_fg.to(torch.int32), dim=1).bool()
        trailing = torch.cumprod(seg_fg.flip(1).to(torch.int32), dim=1).bool().flip(1)
        seg[:] = torch.where(leading, torch.minimum(seg, m_near[:, None]), seg)
        seg[:] = torch.where(trailing, torch.minimum(seg, m_far[:, None]), seg)


def _bounds(n, piece):
    return [(s, min(n, s + piece)) for s in range(0, n, piece)]


def model_labels(mask, n_iters, bands, chunk):
    """Labels of a (B, H, W) bool mask as the resident kernel computes them
    with `bands` blocks a frame and rows cut into `chunk`-pixel chunks."""
    B, H, W = mask.shape
    bg = H * W
    idx = torch.arange(H * W, dtype=torch.int32).reshape(1, H, W)
    labels = torch.where(mask, idx, torch.tensor(bg, dtype=torch.int32)).contiguous()
    rows = -(-H // bands)
    bands_bounds = [(min(H, r * rows), min(H, (r + 1) * rows)) for r in range(bands)]
    for _ in range(n_iters):
        lines = labels.reshape(B * H, W)
        _piece_pass(lines, _bounds(W, chunk), bg)
        cols = labels.transpose(1, 2).reshape(B * W, H).contiguous()
        _piece_pass(cols, bands_bounds, bg)
        labels = cols.reshape(B, W, H).transpose(1, 2).contiguous()
    return labels


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def _chain_mask(H=47, W=29):
    """Columns that are foreground across whole bands. Column 0 carries label
    0 down from the top; a hook along the last row and up column 2 makes
    the minimum of column 2 arrive at its bottom in round 2 and climb; column
    6 is cut once, column 9 is foreground throughout beside a dense field."""
    rng = np.random.default_rng(21)
    m = np.zeros((2, H, W), bool)
    m[:, :, 10:] = rng.uniform(size=(2, H, W - 10)) < 0.8
    m[:, :, 0] = m[:, -1, :3] = m[:, 5:, 2] = True
    m[:, :, 6] = True
    m[:, H // 2, 6] = False
    m[:, :, 9] = True
    m[1, :, 12:20] = True  # rows that are foreground across whole chunks
    return m


MASKS = {
    "random_ragged": lambda: np.random.default_rng(22).uniform(size=(2, 37, 50)) < 0.55,
    "dense": lambda: np.random.default_rng(23).uniform(size=(1, 45, 40)) < 0.93,
    "chains": _chain_mask,
    "few_rows": lambda: np.random.default_rng(24).uniform(size=(2, 5, 33)) < 0.7,  # fewer rows than bands
}


@functools.lru_cache(maxsize=None)
def _references(case, n_iters):
    m = MASKS[case]()
    plain = DK.connected_components(torch.from_numpy(m), n_iters)
    pallas = np.asarray(connected_components_pallas(m, n_iters=n_iters, interpret=True))
    return m, plain, pallas


@pytest.mark.parametrize("bands", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_iters", [0, 1, 4, 12])
@pytest.mark.parametrize("case", list(MASKS))
def test_banded_model_equals_plain_and_interpreted_pallas(case, n_iters, bands):
    m, plain, pallas = _references(case, n_iters)
    got = model_labels(torch.from_numpy(m), n_iters, bands, chunk=8)
    assert got.dtype == torch.int32
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_chain_mask_needs_the_carry_in_both_directions():
    """The hook's label 0 reaches the top of column 2 only by climbing
    through bands that are foreground throughout; without step (b) it
    cannot, so this mask tells a kernel without the carry from one with."""
    m = torch.from_numpy(_chain_mask())
    got = model_labels(m, 4, bands=16, chunk=8)
    assert (got[:, :, 0] == 0).all() and (got[:, 5:, 2] == 0).all() and (got[:, -1, :3] == 0).all()
    one = model_labels(m, 1, bands=16, chunk=8)
    assert (one[:, :, 0] == 0).all() and (one[:, 5:, 2] == 5 * 29 + 2).all()  # the climb starts in round 2


def test_model_with_one_piece_is_the_plain_scan_pair(rng):
    m = torch.from_numpy(rng.uniform(size=(1, 20, 24)) < 0.6)
    assert torch.equal(model_labels(m, 3, bands=1, chunk=24), DK.connected_components(m, 3))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "720p": ((720, 1280), (16, 45)),
    "1080p": ((1080, 1920), None),
    "small": ((70, 130), (1, 70)),
    "one_block_limit": ((45, 1280), (1, 45)),
    "two_blocks": ((46, 1280), (2, 23)),
    "tall_narrow": ((3601, 33), (4, 901)),
    "empty_trailing_block": ((225, 2048), (16, 15)),  # 15 blocks x 15 rows, the sixteenth holds none
    "short_trailing_block": ((226, 2048), (16, 15)),
    "widest": ((28, 2048), (1, 28)),
    "too_wide": ((8, 2049), None),
    "too_large": ((2160, 448), None),
    "single_pixel": ((1, 1), (1, 1)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_resident_plan(case):
    (H, W), want = PLAN_CASES[case]
    plan = TC.resident_plan(H, W)
    assert plan == want
    if plan is not None:
        blocks, rows = plan
        assert blocks in TC.CLUSTER_SIZES and blocks * rows >= H and (blocks - 1) * rows <= H + rows
        assert TC.resident_bytes(rows, W) <= TC.BLOCK_SHARED_BYTES
        if blocks > 1:  # the smallest cluster that fits
            assert TC.resident_bytes(-(-H // (blocks // 2)), W) > TC.BLOCK_SHARED_BYTES


def test_resident_plan_depends_on_the_shape_only_and_720p_fits_with_its_flags():
    assert TC.resident_plan(720, 1280) == TC.resident_plan(720, 1280)
    # 45 rows of 1280 labels, 1280 column flags, 225 chunk flags (padded to 228)
    assert TC.resident_bytes(45, 1280) == 230_400 + 1_280 + 228 <= 232_448
    assert TC.resident_bytes(46, 1280) > 232_448


@pytest.mark.parametrize("n_iters", [0, 3])
def test_wrapper_on_cpu_takes_the_plain_version_whatever_the_plan(rng, n_iters):
    for shape in ((1, 30, 40), (1, 4, 2100)):  # resident plan; two-launch plan
        m = torch.from_numpy(rng.uniform(size=shape) < 0.5)
        before = (TC.connected_components.launches, TC.connected_components.resident_launches)
        got = TC.connected_components(m, n_iters)
        assert (TC.connected_components.launches, TC.connected_components.resident_launches) == before
        assert torch.equal(got, DK.connected_components(m, n_iters))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# shape, foreground share, the plan it must take
CUDA_CASES = {
    "1_block": ((2, 45, 1280), 0.5, (1, 45)),
    "2_blocks": ((1, 90, 1280), 0.6, (2, 45)),
    "4_blocks_ragged_width": ((1, 180, 1270), 0.45, (4, 45)),
    "8_blocks": ((1, 224, 2048), 0.5, (8, 28)),
    "16_blocks_empty_trailing": ((2, 225, 2048), 0.6, (16, 15)),
    "16_blocks_short_trailing": ((1, 226, 2047), 0.9, (16, 15)),
    "720p": ((2, 720, 1280), 0.45, (16, 45)),
    "tall_bands": ((2, 3601, 33), 0.97, (4, 901)),
    "two_launch_tall": ((1, 2160, 448), 0.9, None),
    "two_launch_wide": ((1, 40, 2100), 0.5, None),
}


def chain_mask_for(shape, p, rng):
    """A random mask with the hook of `_chain_mask` and two columns that are
    foreground throughout, at the frame's own size."""
    m = rng.uniform(size=shape) < p
    m[:, :, :12] = False
    m[:, :, 0] = m[:, -1, :3] = m[:, 5:, 2] = True
    m[:, :, 6] = m[:, :, 9] = True
    m[:, shape[1] // 2, 6] = False
    m[:, shape[1] // 3, 20:] = True  # a row that is foreground across whole chunks
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_compiled_ccl_paths_match_plain_on_cuda(rng, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    shape, p, plan = CUDA_CASES[case]
    assert TC.resident_plan(*shape[1:]) == plan
    for m in (rng.uniform(size=shape) < p, chain_mask_for(shape, p, rng)):
        m = torch.from_numpy(m).cuda()
        for n_iters in (0, 1, 4, 12):
            before = (TC.connected_components.launches, TC.connected_components.resident_launches)
            got = TC.connected_components(m, n_iters)
            torch.cuda.synchronize()
            after = (TC.connected_components.launches, TC.connected_components.resident_launches)
            assert after == (before[0] + 1, before[1] + (plan is not None))
            assert torch.equal(got, TC.connected_components_plain(m, n_iters))


@pytest.mark.cuda
def test_resident_clusters_fit_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    assert TC.resident_max_active_clusters(720, 1280) >= 1
