"""The port's batched image kernels (caliscope_tpu_torch.detect.kernels)
held against the JAX package's (caliscope_tpu.detect.kernels) on the same
seeded numpy inputs, float32 on both sides.

The float32 integral image is exact, whatever the scan order, while every
partial sum stays below 2**24: integer-valued 128x160 crops (192x224 padded,
at most 255 * 43,008 < 2**24) must give the same integral and thresholds
bit for bit. On the whole 240x320 frames the sums pass 2**24, so the stages
after the threshold are fed the reference's own mask and labels, and must
match bit for bit up to the patches. Quads, refined quads and cell means go through float sums in
another order: they are compared on valid candidates with atol 1e-2 px and
1e-2 gray levels (observed maxima on the frames here: 0 px for the mask
quads, 1.0e-3 px for the refined quads, 2.0e-5 gray levels for the cell
means; the test prints them).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.detect.kernels as JK
from caliscope_tpu.detect.pallas_ccl import connected_components_pallas
from caliscope_tpu.targets.charuco import Charuco as JaxCharuco
import caliscope_tpu_torch.detect.kernels as TK
from torch_detect_common import QUAD_FRONT, QUAD_SECOND, board_frame, port_board, t

K_MAX, PATCH, MIN_AREA = 64, 96, 49


@pytest.fixture(scope="module")
def frames():
    ch = port_board(JaxCharuco(rows=5, columns=7, square_size_m=0.054))
    blobs = np.full((240, 320), 255, np.uint8)  # large blobs: the coarser pyramid levels
    blobs[20:130, 15:165] = 0
    blobs[140:220, 200:290] = 0
    blobs[150:180, 30:70] = 40
    stack = np.stack([board_frame(ch, QUAD_FRONT)[0], board_frame(ch, QUAD_SECOND)[0], blobs])
    return stack.astype(np.float32)


@pytest.fixture(scope="module")
def jax_stages(frames):
    """Every stage of the reference marker graph on `frames`, as numpy."""
    imgs = jnp.asarray(frames)
    integral = JK.integral_image(imgs)
    binary = JK.adaptive_threshold(imgs, 10, 7.0, integral) | JK.adaptive_threshold(imgs, 26, 7.0, integral)
    labels = JK.connected_components(binary, n_iters=4)
    sel, areas, bbox, valid = JK.component_candidates_sorted(binary, labels, K_MAX, float(MIN_AREA))
    gray, mask, origin, scale = JK.extract_patches(imgs, binary, labels, sel, bbox, PATCH)
    quads0 = JK.quad_corners_from_mask(mask)
    quads = JK.refine_quad_edges(gray, quads0)
    cells = JK.sample_marker_bits(gray, quads, 4)
    out = dict(integral=integral, binary=binary, labels=labels, sel=sel, areas=areas, bbox=bbox, valid=valid,
               gray=gray, mask=mask, origin=origin, scale=scale, quads0=quads0, quads=quads, cells=cells)
    return {k: np.asarray(v) for k, v in out.items()}


def _random_masks(rng):
    return [rng.uniform(size=shape) < p for shape, p in (((2, 64, 128), 0.4), ((1, 70, 130), 0.55), ((2, 48, 256), 0.3), ((1, 40, 136), 0.35))]


def _crop(frames):
    return np.ascontiguousarray(frames[:, 56:184, 80:240])


def test_integral_image_bit_for_bit(frames):
    crop = _crop(frames)
    got = TK.integral_image(t(crop))
    assert got.dtype == torch.float32 and float(got.max()) < 2**24
    np.testing.assert_array_equal(got.numpy(), np.asarray(JK.integral_image(jnp.asarray(crop))))


def test_integral_image_close_on_whole_frames(frames, jax_stages):
    got = TK.integral_image(t(frames)).numpy()
    np.testing.assert_allclose(got, jax_stages["integral"], rtol=3e-7)


@pytest.mark.parametrize("radius", [10, 26])
def test_adaptive_threshold_bit_for_bit(frames, radius):
    crop = _crop(frames)
    want = np.asarray(JK.adaptive_threshold(jnp.asarray(crop), radius, 7.0))
    got = TK.adaptive_threshold(t(crop), radius, 7.0)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("n_iters", [1, 4, 12])
def test_connected_components_matches_twin_and_pallas_kernel(rng, n_iters):
    for m in _random_masks(rng):
        got = TK.connected_components(t(m), n_iters=n_iters)
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(JK.connected_components(m, n_iters=n_iters)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(connected_components_pallas(m, n_iters=n_iters, interpret=True))
        )


def test_connected_components_on_board_mask(jax_stages):
    got = TK.connected_components(t(jax_stages["binary"]), n_iters=4)
    np.testing.assert_array_equal(got.numpy(), jax_stages["labels"])


@pytest.mark.parametrize("n_iters", [1, 3])
def test_scan_pair_is_run_minimum(rng, n_iters):
    """A forward then backward segmented running min leaves the run's
    minimum in every pixel of a run (what the CUDA kernel computes per
    pass): rounds of "row runs take their min, column runs take their min"
    reproduce the scans exactly."""
    m = rng.uniform(size=(2, 37, 45)) < 0.6
    B, H, W = m.shape
    lab = np.where(m, np.arange(H * W, dtype=np.int32).reshape(1, H, W), H * W)

    def run_min(lab, fg):  # along the last axis
        out = lab.copy()
        for idx in np.ndindex(lab.shape[:-1]):
            row, f = lab[idx], fg[idx]
            i = 0
            while i < len(row):
                if not f[i]:
                    i += 1
                    continue
                j = i
                while j + 1 < len(row) and f[j + 1]:
                    j += 1
                out[idx][i : j + 1] = row[i : j + 1].min()
                i = j + 1
        return out

    for _ in range(n_iters):
        lab = run_min(lab, m)
        lab = run_min(lab.transpose(0, 2, 1), m.transpose(0, 2, 1)).transpose(0, 2, 1)
    np.testing.assert_array_equal(TK.connected_components(t(m), n_iters=n_iters).numpy(), lab)


def test_pool_mask(rng):
    m = rng.uniform(size=(2, 50, 70)) < 0.1
    np.testing.assert_array_equal(TK.pool_mask(t(m), 4).numpy(), np.asarray(JK.pool_mask(jnp.asarray(m), 4)))


def test_component_candidates_sorted(jax_stages):
    sel, areas, bbox, valid = TK.component_candidates_sorted(
        t(jax_stages["binary"]), t(jax_stages["labels"]), K_MAX, float(MIN_AREA)
    )
    assert jax_stages["valid"].sum() >= 30  # the board's markers and squares
    np.testing.assert_array_equal(valid.numpy(), jax_stages["valid"])
    np.testing.assert_array_equal(sel.numpy(), jax_stages["sel"])
    v = jax_stages["valid"]  # slots past the last valid one hold whatever scored -1 first
    np.testing.assert_array_equal(bbox.numpy()[v], jax_stages["bbox"][v])
    np.testing.assert_array_equal(areas.numpy()[v], jax_stages["areas"][v])


def test_component_candidates_ties_take_the_lower_position_first(rng):
    """Equal areas are the rule (multiples of 16 px): slots must match the
    reference's top_k order, lower sorted position first."""
    img = np.full((1, 96, 160), 255.0, np.float32)
    for k in range(9):  # nine identical, cell-aligned blobs: nine equal areas
        x0 = 8 + 16 * k
        img[0, 40:52, x0 : x0 + 8] = 0.0
    binary = JK.adaptive_threshold(jnp.asarray(img), 10)
    labels = JK.connected_components(binary, n_iters=4)
    want = JK.component_candidates_sorted(binary, labels, 6, 25.0)
    got = TK.component_candidates_sorted(t(np.asarray(binary)), t(np.asarray(labels)), 6, 25.0)
    assert np.asarray(want[3]).all() and len(set(np.asarray(want[1])[0].tolist())) == 1  # six valid slots, all tied
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_extract_patches_fed_the_reference_labels(frames, jax_stages):
    gray, mask, origin, scale = TK.extract_patches(
        t(frames), t(jax_stages["binary"]), t(jax_stages["labels"]), t(jax_stages["sel"]), t(jax_stages["bbox"]), PATCH
    )
    np.testing.assert_array_equal(gray.numpy(), jax_stages["gray"])
    np.testing.assert_array_equal(mask.numpy(), jax_stages["mask"])
    np.testing.assert_array_equal(origin.numpy(), jax_stages["origin"])
    np.testing.assert_array_equal(scale.numpy(), jax_stages["scale"])
    assert len(np.unique(jax_stages["scale"])) >= 2  # more than one pyramid level in use


def test_quads_and_cells_on_valid_candidates(jax_stages):
    v = jax_stages["valid"]
    quads0 = TK.quad_corners_from_mask(t(jax_stages["mask"]))
    d0 = np.abs(quads0.numpy() - jax_stages["quads0"])[v].max()
    assert d0 <= 1e-2, f"mask quads differ by {d0} px"
    quads = TK.refine_quad_edges(t(jax_stages["gray"]), t(jax_stages["quads0"]))
    d1 = np.abs(quads.numpy() - jax_stages["quads"])[v].max()
    assert d1 <= 1e-2, f"refined quads differ by {d1} px"
    cells = TK.sample_marker_bits(t(jax_stages["gray"]), t(jax_stages["quads"]), 4)
    assert cells.shape == jax_stages["cells"].shape
    d2 = np.abs(cells.numpy() - jax_stages["cells"])[v].max()
    assert d2 <= 1e-2, f"cell means differ by {d2} gray levels"
    print(f"observed maxima: mask quads {d0} px, refined quads {d1} px, cell means {d2} gray levels")


def test_homography_from_unit_square(rng):
    quad = (np.array([[10, 12], [60, 15], [58, 70], [8, 64]], np.float32) + rng.normal(size=(5, 4, 2))).astype(np.float32)
    got = TK.homography_from_unit_square(t(quad)).numpy()
    np.testing.assert_allclose(got, np.asarray(JK.homography_from_unit_square(jnp.asarray(quad))), rtol=1e-5, atol=1e-5)
    # the unit square's corners land on the quad
    for i, (u, v_) in enumerate([(0, 0), (1, 0), (1, 1), (0, 1)]):
        p = got @ np.array([u, v_, 1.0], np.float32)
        np.testing.assert_allclose(p[:, :2] / p[:, 2:], quad[:, i], atol=1e-3)
