"""The plain versions of the port's three detection kernels
(caliscope_tpu_torch.detect.ccl, .cuda_kernels) held against the JAX
package's Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them; and the wrappers' input checks.

Here, on the CPU, each wrapper computes its plain version; the CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py and by the `cuda`-marked tests below, which skip without a
GPU, all three equal to their plain versions. Labels and windows must be
equal to the interpreted Pallas kernels bit for bit; the ring response
within rtol 1e-4, atol 1e-3 of the interpreted Pallas kernel over the whole
frame (border included, both zero there) and of the jnp twin on [6:-6,
6:-6] (the twin does not mask its border).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.detect import kernels as JK
from caliscope_tpu.detect.corners import chess_corner_response as jax_response_twin
from caliscope_tpu.detect.pallas_ccl import connected_components_pallas
from caliscope_tpu.detect.pallas_kernels import chess_corner_response_pallas, extract_windows_pallas
from caliscope_tpu_torch.detect import ccl as TC
from caliscope_tpu_torch.detect import corners as TCo
from caliscope_tpu_torch.detect import cuda_kernels as CK
from torch_detect_common import t


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")


# ---------------------------------------------------------------------------
# labeling
# ---------------------------------------------------------------------------

MASK_CASES = {"aligned": ((2, 64, 128), 0.4), "ragged": ((1, 70, 130), 0.55), "wide": ((2, 48, 256), 0.3), "w136": ((1, 40, 136), 0.35)}
# tall and dense, with runs thousands of rows long. The first two are narrow
# enough to fit a cluster (resident path on the card, bands of up to 901
# rows). The last two fit none and are taller than the 1,760 rows of a column
# strip that the two-launch kernel stages at once: two segments and three
TALL_MASK_CASES = {
    "rows2160": ((1, 2160, 40), 0.9), "rows3601": ((2, 3601, 33), 0.97),
    "rows2160_two_segments": ((1, 2160, 448), 0.9), "rows3601_three_segments": ((1, 3601, 300), 0.97),
}


def _tall_mask(rng, case):
    """Dense, with a hook down column 0, along the last row and up column
    2: from the second round on the hook's minimum climbs column 2. Three
    segments get columns that are foreground throughout instead: the hook's
    background column would overflow the JAX reference's int32 offsets
    there (a background pixel counts as a segment of its line), and the CPU
    test holds these masks to the reference; the cuda-marked test adds the
    hooked three-segment mask (`_hooked_three_segments`)."""
    shape, p = TALL_MASK_CASES[case]
    m = rng.uniform(size=shape) < p
    if case == "rows3601_three_segments":
        m[:, :, 0] = m[:, -1, :] = m[:, 5:, 2] = True
        return m
    m[:, :, :4] = False
    m[:, :, 0] = m[:, -1, :3] = m[:, 5:, 2] = True
    return m


@pytest.mark.parametrize("case", list(MASK_CASES))
@pytest.mark.parametrize("n_iters", [0, 1, 4, 12])
def test_ccl_wrapper_matches_interpreted_pallas_kernel(rng, case, n_iters):
    shape, p = MASK_CASES[case]
    m = rng.uniform(size=shape) < p
    before = TC.connected_components.launches
    got = TC.connected_components(t(m), n_iters=n_iters)
    assert TC.connected_components.launches == before  # CPU: the plain version, no launch
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(connected_components_pallas(m, n_iters=n_iters, interpret=True)))
    H, W = shape[1:]
    assert (got.numpy()[~m] == H * W).all() and got.numpy()[m].max() < H * W


@pytest.mark.parametrize("case", list(TALL_MASK_CASES))
def test_ccl_wrapper_takes_frames_of_any_height(rng, case):
    m = _tall_mask(rng, case)
    got = TC.connected_components(t(m), n_iters=2).numpy()
    np.testing.assert_array_equal(got, np.asarray(JK.connected_components(jnp.asarray(m), n_iters=2)))
    assert (got[:, :, 0] == 0).all() and (got[:, 5:, 2] == 0).all()


def _bad_ccl(rng):
    m = t(rng.uniform(size=(1, 16, 24)) < 0.5)
    return {
        "uint8": ((m.to(torch.uint8), 4), TypeError),
        "not_a_tensor": ((m.numpy(), 4), TypeError),
        "two_dims": ((m[0], 4), ValueError),
        "non_contiguous": ((m.transpose(1, 2), 4), ValueError),
        "meta_device": ((torch.empty(m.shape, dtype=torch.bool, device="meta"), 4), ValueError),
        "negative_iters": ((m, -1), ValueError),
        "too_wide": ((torch.zeros((1, 8, TC.MAX_WIDTH + 1), dtype=torch.bool), 4), ValueError),
        # H * W + 1 >= 2**31 pixels: the int32 labels' limit (checked before
        # the device, so a meta tensor of that shape shows it)
        "too_many_pixels": ((torch.empty((1, 2**31 // TC.MAX_WIDTH + 1, TC.MAX_WIDTH), dtype=torch.bool, device="meta"), 4), ValueError),
    }


@pytest.mark.parametrize(
    "case", ["uint8", "not_a_tensor", "two_dims", "non_contiguous", "meta_device", "negative_iters", "too_wide", "too_many_pixels"]
)
def test_ccl_wrapper_raises_on_what_the_kernel_cannot_take(rng, case):
    args, exc = _bad_ccl(rng)[case]
    with pytest.raises(exc, match="connected_components"):
        TC.connected_components(*args)


# ---------------------------------------------------------------------------
# ring response
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 96, 128), (2, 97, 131)], ids=["aligned", "ragged"])
def test_response_matches_interpreted_pallas_kernel_and_twin(rng, shape):
    imgs = rng.uniform(0, 255, size=shape).astype(np.float32)
    got = CK.corner_response(t(imgs)).numpy()  # CPU: the plain version
    ker = np.asarray(chess_corner_response_pallas(imgs, interpret=True))
    np.testing.assert_allclose(got, ker, rtol=1e-4, atol=1e-3)
    pad = CK.PAD
    assert pad == 6 == int(np.ceil(CK.RADIUS)) + 2
    border = np.ones(shape, bool)
    border[:, pad:-pad, pad:-pad] = False
    assert (got[border] == 0).all() and (got[~border] > 0).any()
    twin = np.asarray(jax_response_twin(imgs))
    np.testing.assert_allclose(got[:, pad:-pad, pad:-pad], twin[:, pad:-pad, pad:-pad], rtol=1e-4, atol=1e-3)
    # the port's copy of the twin (unmasked border) against the reference's
    np.testing.assert_allclose(TCo.chess_corner_response(t(imgs)).numpy(), twin, rtol=1e-4, atol=1e-3)


def test_response_peaks_at_a_rendered_corner():
    img = np.zeros((64, 64), np.float32)
    img[:32, :32] = 255
    img[32:, 32:] = 255
    resp = CK.corner_response(t(img[None]))[0].numpy()
    peak = np.unravel_index(np.argmax(resp), resp.shape)
    assert abs(peak[0] - 31.5) <= 1 and abs(peak[1] - 31.5) <= 1


def test_response_of_a_frame_smaller_than_the_border_is_zero():
    assert (CK.corner_response(torch.rand(1, 10, 40)) == 0).all()


def test_ring_taps_split():
    offsets, weights = CK.ring_taps()
    ring = TCo._ring_offsets(CK.RADIUS)
    assert offsets.shape == (16, 2) and weights.shape == (16, 4)
    np.testing.assert_allclose(offsets[:, 0] + weights[:, 1], ring[:, 1], atol=1e-6)  # iy + fy = dy
    np.testing.assert_allclose(offsets[:, 1] + weights[:, 3], ring[:, 0], atol=1e-6)  # ix + fx = dx
    assert np.abs(offsets).max() + 1 <= CK.PAD


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

WINDOW_CASES = {
    "f32_win28": (np.float32, (2, 96, 160), 16, 28),
    "i32_win64": (np.int32, (2, 200, 300), 8, 64),
    "i32_win96": (np.int32, (2, 200, 300), 8, 96),
}


def _window_case(rng, case):
    dtype, (B, Hp, Wp), K, win = WINDOW_CASES[case]
    if dtype == np.float32:
        img = rng.uniform(0, 255, size=(B, Hp, Wp)).astype(np.float32)
    else:
        img = rng.integers(0, 2**30, size=(B, Hp, Wp)).astype(np.int32)
    yi = rng.integers(0, Hp - win + 1, size=(B, K)).astype(np.int32)
    xi = rng.integers(0, Wp - win + 1, size=(B, K)).astype(np.int32)
    # every clip corner
    yi[:, :4] = [0, 0, Hp - win, Hp - win]
    xi[:, :4] = [0, Wp - win, 0, Wp - win]
    return img, yi, xi, win


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windows_match_interpreted_pallas_kernel(rng, case):
    img, yi, xi, win = _window_case(rng, case)
    before = CK.extract_windows.launches
    got = CK.extract_windows(t(img), t(yi), t(xi), win)
    assert CK.extract_windows.launches == before
    assert got.dtype == t(img).dtype and tuple(got.shape) == (*yi.shape, win, win)
    want = np.asarray(extract_windows_pallas(jnp.asarray(img), jnp.asarray(yi), jnp.asarray(xi), win, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    b, k = 1, 5
    np.testing.assert_array_equal(got.numpy()[b, k], img[b, yi[b, k] : yi[b, k] + win, xi[b, k] : xi[b, k] + win])


def test_windows_clamp_seeds_outside_the_frame(rng):
    img, yi, xi, win = _window_case(rng, "f32_win28")
    B, Hp, Wp = img.shape
    far = CK.extract_windows(t(img), t(yi + 1000), t(xi - 1000), win).numpy()
    corner = np.broadcast_to(img[:, None, Hp - win :, :win], far.shape)
    np.testing.assert_array_equal(far, corner)


def _bad_windows(rng):
    img, yi, xi, win = _window_case(rng, "f32_win28")
    f, y, x = t(img), t(yi), t(xi)
    meta = lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta")  # noqa: E731
    return {
        "float64_frames": ((f.double(), y, x, win), TypeError),
        "int64_seeds": ((f, y.long(), x, win), TypeError),
        "non_contiguous_frames": ((f.transpose(1, 2), y, x, win), ValueError),
        "non_contiguous_seeds": ((f, y.T.contiguous().T, x, win), ValueError),
        "seeds_off_device": ((f, meta(y), x, win), ValueError),
        "frames_off_device": ((meta(f), y, x, win), ValueError),
        "seed_shapes_differ": ((f, y, x[:, :3].contiguous(), win), ValueError),
        "window_larger_than_frame": ((f, y, x, 97), ValueError),
        "not_a_tensor": ((img, y, x, win), TypeError),
    }


@pytest.mark.parametrize(
    "case",
    ["float64_frames", "int64_seeds", "non_contiguous_frames", "non_contiguous_seeds", "seeds_off_device",
     "frames_off_device", "seed_shapes_differ", "window_larger_than_frame", "not_a_tensor"],
)
def test_windows_wrapper_raises_on_what_the_kernel_cannot_take(rng, case):
    args, exc = _bad_windows(rng)[case]
    with pytest.raises(exc, match="extract_windows"):
        CK.extract_windows(*args)


BAD_WINDOW_CASES = ["float64_frames", "int64_seeds", "non_contiguous_frames", "non_contiguous_seeds", "seeds_off_device",
                    "frames_off_device", "seed_shapes_differ", "window_larger_than_frame", "not_a_tensor"]


@pytest.mark.parametrize("case", BAD_WINDOW_CASES)
def test_windows_quick_check_passes_nothing_the_full_checks_refuse(rng, case):
    args, _ = _bad_windows(rng)[case]
    assert CK._fits(*args) is None


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windows_quick_check_passes_what_the_kernel_takes(rng, case):
    img, yi, xi, win = _window_case(rng, case)
    assert CK._fits(t(img), t(yi), t(xi), win) == (*img.shape, yi.shape[1])


def _unaligned(values, device="cpu"):
    """`values` (float32) in a contiguous tensor on `device` whose data
    start one word past a 16-byte boundary."""
    out = torch.zeros(values.size + 1, dtype=torch.float32, device=device)[1:].view(values.shape)
    return out.copy_(t(values))


# (frames shape, dtype, win) -> the kernel's path: each caller's shape on
# the TMA path; what TMA cannot copy on the rows path
WINDOW_PATH_CASES = {
    "atlas": (((8, 1356, 1280), torch.int32, 96), "tma"),
    "corner_windows": (((8, 748, 1308), torch.float32, 28), "tma"),
    "chessboard_k512": (((1, 748, 1308), torch.float32, 28), "tma"),
    "aruco_tracker_atlas": (((1, 1356, 1280), torch.int32, 96), "tma"),
    "wp_not_multiple_of_4_1366_wide": (((1, 796, 1394), torch.float32, 28), "rows"),
    "ragged_frame": (((2, 97, 131), torch.float32, 28), "rows"),
    "win_not_multiple_of_4": (((2, 200, 300), torch.float32, 17), "rows"),
    "win_above_256": (((1, 300, 300), torch.int32, 260), "rows"),
    "two_stages_do_not_fit": (((1, 300, 300), torch.int32, 120), "rows"),
    "unaligned_base": (((2, 40, 64), "unaligned", 8), "rows"),
    "aligned_twin_of_unaligned": (((2, 40, 64), torch.float32, 8), "tma"),
}


@pytest.mark.parametrize("case", list(WINDOW_PATH_CASES))
def test_windows_path_rule(case):
    (shape, dtype, win), path = WINDOW_PATH_CASES[case]
    frames = _unaligned(np.zeros(shape, np.float32)) if dtype == "unaligned" else torch.empty(shape, dtype=dtype)
    assert frames.is_contiguous()
    assert CK.windows_path(frames, win) == path
    stages = CK.tma_stages(frames.shape[2], win, frames.data_ptr())
    assert (stages > 0) == (path == "tma")


@pytest.mark.parametrize("case", ["float64", "non_contiguous", "two_dims", "not_a_tensor"])
def test_response_wrapper_raises_on_what_the_kernel_cannot_take(rng, case):
    f = torch.rand(2, 40, 50)
    bad = {"float64": f.double(), "non_contiguous": f.transpose(1, 2), "two_dims": f[0], "not_a_tensor": f.numpy()}[case]
    with pytest.raises((TypeError, ValueError), match="corner_response"):
        CK.corner_response(bad)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _hooked_three_segments(rng):
    """(1, 3601, 300) with the hook of `_tall_mask` and its background
    columns: the plain version is exact on it, the JAX reference is not."""
    m = rng.uniform(size=(1, 3601, 300)) < 0.97
    m[:, :, :4] = False
    m[:, :, 0] = m[:, -1, :3] = m[:, 5:, 2] = True
    return m


@pytest.mark.cuda
def test_compiled_ccl_matches_plain_on_cuda(rng):
    _need_cuda()
    masks = [rng.uniform(size=shape) < p for shape, p in MASK_CASES.values()]
    tall = [_tall_mask(rng, case) for case in TALL_MASK_CASES] + [_hooked_three_segments(rng), rng.uniform(size=(1, 1080, 1920)) < 0.45]
    for m in (*masks, *tall):
        m = t(m).cuda()
        for n_iters in (0, 1, 4, 12):
            before = TC.connected_components.launches
            got = TC.connected_components(m, n_iters=n_iters)
            torch.cuda.synchronize()
            assert TC.connected_components.launches == before + 1
            assert torch.equal(got, TC.connected_components_plain(m, n_iters))


@pytest.mark.cuda
def test_compiled_response_matches_plain_on_cuda(rng):
    _need_cuda()
    zeros = rng.normal(scale=40.0, size=(2, 96, 160)).astype(np.float32)
    zeros[:, 8:60, 10:90] = 0.0
    zeros[:, 40:90, 60:150] = -0.0
    frames = [rng.uniform(0, 255, size=shape).astype(np.float32) for shape in ((2, 96, 128), (2, 97, 131), (1, 10, 40), (3, 20, 100))]
    for x in (*frames, zeros):
        imgs = t(x).cuda()
        before = CK.corner_response.launches
        got = CK.corner_response(imgs)
        torch.cuda.synchronize()
        assert CK.corner_response.launches == before + 1
        assert torch.equal(got, CK.corner_response_plain(imgs))  # the same float32 operations in the same order


@pytest.mark.cuda
def test_compiled_windows_match_plain_on_cuda(rng):
    """Both paths: the window cases (TMA) and, on the rows path, a ragged
    frame, win 17, a 1366-wide frame padded by 14 and an unaligned base;
    tma_launches grows on the TMA path only."""
    _need_cuda()
    cases = [_window_case(rng, case) for case in WINDOW_CASES]
    for (B, Hp, Wp), win in (((2, 97, 131), 28), ((2, 200, 300), 17), ((1, 796, 1394), 28)):
        img = rng.uniform(0, 255, size=(B, Hp, Wp)).astype(np.float32)
        seeds = [rng.integers(-3, n - win + 4, size=(B, 9)).astype(np.int32) for n in (Hp, Wp)]
        cases.append((img, *seeds, win))
    img = rng.uniform(0, 255, size=(2, 40, 64)).astype(np.float32)
    unaligned = (img, *(rng.integers(0, 33, size=(2, 5)).astype(np.int32) for _ in range(2)), 8)
    paths = []
    for case in cases + [unaligned]:
        img, yi, xi, win = case
        f = _unaligned(img, "cuda") if case is unaligned else t(img).cuda()
        y, x = t(yi).cuda(), t(xi).cuda()
        path = CK.windows_path(f, win)
        paths.append(path)
        before, tma_before = CK.extract_windows.launches, CK.extract_windows.tma_launches
        got = CK.extract_windows(f, y, x, win)
        torch.cuda.synchronize()
        assert CK.extract_windows.launches == before + 1
        assert CK.extract_windows.tma_launches == tma_before + (path == "tma")
        assert got.dtype == f.dtype and torch.equal(got, CK.extract_windows_plain(f, y, x, win))
    assert paths == ["tma"] * len(WINDOW_CASES) + ["rows"] * 4
