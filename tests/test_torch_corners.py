"""The port's X-corner stage (caliscope_tpu_torch.detect.corners) held
against the JAX package's (caliscope_tpu.detect.corners) on the same seeded
frames, float32 on both sides.

The pipeline's response is the kernel's function (border zeroed), so the
reference side runs the Pallas kernel in interpret mode. NMS peaks are
compared as sets of valid slots (score-0 slots tie and are all invalid);
subpixel corners within 1e-3 px (float sums in another order); the numpy
host refinement is a copy and must agree to 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.detect.corners as JC
from caliscope_tpu.detect.pallas_kernels import chess_corner_response_pallas
from caliscope_tpu.targets.charuco import Charuco as JaxCharuco
import caliscope_tpu_torch.detect.corners as TC
from torch_detect_common import QUAD_FRONT, QUAD_SECOND, board_frame, port_board, t

K_MAX = 256


@pytest.fixture(scope="module")
def views():
    ch = port_board(JaxCharuco(rows=5, columns=7, square_size_m=0.054))
    f1, gt1 = board_frame(ch, QUAD_FRONT)
    f2, gt2 = board_frame(ch, QUAD_SECOND)
    return np.stack([f1, f2]).astype(np.float32), [gt1, gt2]


@pytest.fixture(scope="module")
def jax_response(views):
    return np.asarray(chess_corner_response_pallas(jnp.asarray(views[0]), interpret=True))


def _peak_sets(xy, score, valid):
    return [
        {(float(x), float(y), float(s)) for (x, y), s, v in zip(xy[b], score[b], valid[b]) if v}
        for b in range(len(xy))
    ]


def test_response_on_board_frames(views, jax_response):
    got = TC.corner_response(t(views[0])).numpy()
    np.testing.assert_allclose(got, jax_response, rtol=1e-4, atol=1e-3)


def test_nms_valid_peaks_equal_as_sets(jax_response):
    want = [np.asarray(a) for a in JC.nms_corners(jnp.asarray(jax_response), K_MAX)]
    got = [a.numpy() for a in TC.nms_corners(t(jax_response), K_MAX)]
    assert got[0].shape == (2, K_MAX, 2) and got[2].dtype == bool
    w, g = _peak_sets(*want), _peak_sets(*got)
    assert g == w and all(len(s) >= 24 for s in w)
    # slots are in descending score order on both sides: valid ones line up
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1][want[2]], want[1][want[2]])


def test_subpixel_refinement(views, jax_response):
    frames, gts = views
    xy, _score, valid = (np.asarray(a) for a in JC.nms_corners(jnp.asarray(jax_response), K_MAX))
    want = np.asarray(JC.refine_corners_subpix(jnp.asarray(frames), jnp.asarray(xy)))
    got = TC.refine_corners_subpix(t(frames), t(xy)).numpy()
    d = np.abs(got - want)[valid].max()
    assert d <= 1e-3, f"subpixel corners differ by {d} px"
    # and the refined candidates contain the board's true corners
    for b, gt in enumerate(gts):
        near = np.linalg.norm(gt[:, None] - got[b][valid[b]][None], axis=2).min(axis=1)
        assert near.max() < 0.6 and near.mean() < 0.3


def test_xcorner_graph_and_entry_point(views):
    frames, _ = views
    xy, score, valid = TC.detect_x_corners_device(frames, K_MAX, device="cpu")
    assert xy.shape == (2, K_MAX, 2) and xy.dtype == torch.float32 and valid.dtype == torch.bool
    jxy, _s, jvalid = JC.xcorner_graph(jnp.asarray(frames), K_MAX, use_pallas=False)
    # the reference's CPU path uses the unmasked twin; the board stays >= 10 px
    # inside the frame, so the board's corners are the same on both
    got, want = xy.numpy(), np.asarray(jxy)
    for b in range(2):
        g, w = got[b][valid[b].numpy()], want[b][np.asarray(jvalid[b])]
        inner = w[(w[:, 0] > 10) & (w[:, 0] < 310) & (w[:, 1] > 10) & (w[:, 1] < 230)]
        d = np.linalg.norm(inner[:, None] - g[None], axis=2).min(axis=1)
        assert d.max() <= 1e-3


def test_entry_point_needs_cuda_by_default(views):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.detect_x_corners_device(views[0], K_MAX)


@pytest.mark.parametrize("relocalize", [False, True])
def test_host_refinement_is_the_reference_numpy_code(views, rng, relocalize):
    frames, gts = views
    stack = frames.astype(np.uint8)
    seeds = np.concatenate([gts[0], gts[1]]) + rng.uniform(-1.5, 1.5, size=(48, 2))
    fids = np.repeat([0, 1], 24)
    want = JC.refine_corners_subpix_host(stack, seeds, fids, relocalize=relocalize)
    got = TC.refine_corners_subpix_host(stack, seeds, fids, relocalize=relocalize)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.linalg.norm(got - np.concatenate(gts), axis=1).mean() < 0.3
    assert TC.refine_corners_subpix_host(stack, np.zeros((0, 2)), np.zeros(0, np.int64)).shape == (0, 2)
