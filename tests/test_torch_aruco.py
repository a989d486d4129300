"""The port's ArUco stage (caliscope_tpu_torch.detect.aruco, .dictionaries)
held against the JAX package's on the same rendered frames: the marker
graph's candidates (valid slots equal; quads within 0.02 px on valid slots;
cell means within 0.05 gray levels on the slots that decode as markers —
a blob that is no marker can leave cells with almost no pixels, whose mean
is a quotient of two near-zero sums), decoded ids equal and corners within
0.02 px, and the dictionary data and matcher identical.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.detect.aruco as JA
import caliscope_tpu.detect.dictionaries as JD
from caliscope_tpu.targets.charuco import Charuco as JaxCharuco
import caliscope_tpu_torch.detect.aruco as TA
import caliscope_tpu_torch.detect.dictionaries as TD
from torch_detect_common import QUAD_FRONT, QUAD_SECOND, board_frame, port_board, t

ARGS = (4, 64, 96, 49, 4)  # n_bits, k_max, patch, min_area, ccl_iters


@pytest.fixture(scope="module")
def frames():
    ch = port_board(JaxCharuco(rows=5, columns=7, square_size_m=0.054))
    return np.stack([board_frame(ch, QUAD_FRONT)[0], board_frame(ch, QUAD_SECOND)[0], np.full((240, 320), 128, np.uint8)])


def test_dictionary_file_is_a_byte_identical_copy():
    assert TD._DATA_PATH.read_bytes() == JD._DATA_PATH.read_bytes()
    assert TD._DATA_PATH != JD._DATA_PATH and Path(TD.__file__).parent.name == "detect"


@pytest.mark.parametrize("name", ["DICT_4X4_50", "DICT_5X5_100", "DICT_6X6_250"])
def test_dictionaries_equal(name):
    got, want = TD.get_dictionary(name), JD.get_dictionary(name)
    np.testing.assert_array_equal(got.bits, want.bits)
    assert got.max_correction_bits == want.max_correction_bits and got.marker_size == want.marker_size
    np.testing.assert_array_equal(got.rotations_pm1(), want.rotations_pm1())


def test_match_bits_equal(rng):
    d, jd = TD.get_dictionary("DICT_4X4_50"), JD.get_dictionary("DICT_4X4_50")
    bits = np.concatenate(
        [np.stack([np.rot90(d.bits[13], k=r) for r in range(4)]), rng.integers(0, 2, size=(32, 4, 4))]
    ).astype(np.float32)
    got, want = TD.match_bits(bits, d), JD.match_bits(bits, jd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][:4] == 13).all() and (got[2][:4] == 0).all()
    with pytest.raises(KeyError):
        TD.get_dictionary("DICT_NONE")


def test_marker_graph_candidates(frames):
    f32 = frames.astype(np.float32)
    want = [np.asarray(a) for a in JA.marker_graph(jnp.asarray(f32), *ARGS)]
    got = [a.numpy() for a in TA.marker_graph(t(f32), *ARGS)]
    v = want[2]
    np.testing.assert_array_equal(got[2], v)
    assert v[:2].sum() >= 34 and not v[2].any()  # 17 markers a frame at least; none on the blank
    assert np.abs(got[0] - want[0])[v].max() <= 0.02
    c = want[1]
    lo, hi = c.reshape(*c.shape[:2], -1).min(-1), c.reshape(*c.shape[:2], -1).max(-1)
    bits = (c > ((lo + hi) * 0.5)[..., None, None])[:, :, 1:-1, 1:-1].astype(np.float32)
    d = JD.get_dictionary("DICT_4X4_50")
    decoded = v & np.stack([JD.match_bits(bits[b], d)[0] >= 0 for b in range(len(c))])
    assert decoded[:2].sum(axis=1).tolist() == [17, 17]
    assert np.abs(got[1] - want[1])[decoded].max() <= 0.05
    np.testing.assert_array_equal(got[3][v], want[3][v])


def test_detect_markers_ids_and_corners(frames):
    want = JA.detect_markers(frames, "DICT_4X4_50")
    got = TA.detect_markers(frames, "DICT_4X4_50", device="cpu")
    assert len(got) == 3 and len(got[2]) == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.hamming, w.hamming)
        assert g.corners.shape == w.corners.shape
        if len(w):
            assert np.abs(g.corners - w.corners).max() <= 0.02
    assert sorted(got[0].ids.tolist()) == list(range(17))  # the whole 5x7 board


def test_detect_markers_takes_one_frame_and_normalized_floats(frames):
    one = TA.detect_markers(frames[0], TD.get_dictionary("DICT_4X4_50"), device="cpu")
    assert len(one) == 1 and len(one[0]) == 17
    unit = TA.detect_markers(frames[:1].astype(np.float32) / 255.0, "DICT_4X4_50", device="cpu")
    np.testing.assert_array_equal(unit[0].ids, one[0].ids)


def test_detect_markers_needs_cuda_by_default(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.detect_markers(frames, "DICT_4X4_50")


def test_canonical_roll_and_assembly_match(rng):
    c = rng.normal(size=(4, 2))
    for r in range(4):
        np.testing.assert_array_equal(TA._canonical_roll(c, r), JA._canonical_roll(c, r))
