"""The port's plain labeling (caliscope_tpu_torch.detect.kernels.
connected_components, kernel 2's plain version) is exact on frames of any
size its wrapper takes: held against an independent numpy model of the same
rounds of segmented running-min scans, which finds each pixel's run by index
and takes the run's minimum by doubling, with no offset arithmetic.

The JAX reference (caliscope_tpu/detect/kernels.py) subtracts seg_id * (H*W
+ 1) in int32, and every pixel that does not join the one before it starts
a segment, a background pixel too; so its labels are exact only while
(max(H, W) + 1) * (H*W + 1) < 2**31. A 3601 x 260 mask whose column 1 is
background but for its last row shows it: the reference differs from the
model at (3600, 1) and nowhere else, the port nowhere. Where the reference
is exact the port equals it bit for bit (tests/test_torch_detect_kernels.py,
tests/test_torch_detect_cuda_kernels.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.detect import kernels as JK
from caliscope_tpu_torch.detect import ccl as TC
from caliscope_tpu_torch.detect import kernels as TK


def _run_min(values, joined):
    """Running min along the last axis within runs: joined[..., i] puts
    element i in the run of element i - 1."""
    n = values.shape[-1]
    idx = np.broadcast_to(np.arange(n), values.shape)
    start = np.maximum.accumulate(np.where(joined, 0, idx), axis=-1)  # first index of each element's run
    longest = int((idx - start).max()) + 1
    out = values.copy()
    step = 1
    while step < longest:
        reach = np.zeros(values.shape, bool)
        reach[..., step:] = idx[..., step:] - step >= start[..., step:]
        shifted = np.empty_like(out)
        shifted[..., step:] = out[..., :-step]
        out = np.where(reach, np.minimum(out, shifted), out)
        step *= 2
    return out


def _labels_model(mask, n_iters):
    """The labeling's function in numpy int64: start at the linear pixel
    index (background H*W); each round scans rows left to right and right to
    left, then columns top to bottom and bottom to top, each a running min
    within the foreground runs; background is reset after the round."""
    B, H, W = mask.shape
    bg = H * W
    labels = np.where(mask, np.arange(H * W).reshape(1, H, W), bg).astype(np.int64)
    joined_h = np.zeros_like(mask)
    joined_h[:, :, 1:] = mask[:, :, 1:] & mask[:, :, :-1]
    joined_v = np.zeros_like(mask)
    joined_v[:, 1:, :] = mask[:, 1:, :] & mask[:, :-1, :]

    def both_ways(lab, joined):
        lab = _run_min(lab, joined)
        back = np.zeros_like(joined)
        back[..., 1:] = joined[..., ::-1][..., :-1]  # element i joins i + 1, seen from the end
        return _run_min(lab[..., ::-1], back)[..., ::-1]

    for _ in range(n_iters):
        labels = both_ways(labels, joined_h)
        labels = both_ways(labels.transpose(0, 2, 1), joined_v.transpose(0, 2, 1)).transpose(0, 2, 1)
        labels = np.where(mask, labels, bg)
    return labels.astype(np.int32)


def _background_column_mask(seed):
    """3601 x 260, dense, column 1 background but for the last row, which is
    foreground throughout: column 1's scans see 3,601 segments."""
    m = np.random.default_rng(seed).uniform(size=(1, 3601, 260)) < 0.9
    m[:, :, 1] = False
    m[:, -1, :] = True
    return m


@pytest.mark.parametrize("n_iters", [1, 4])
def test_plain_labels_are_exact_where_the_reference_overflows(n_iters):
    m = _background_column_mask(seed=n_iters)
    want = _labels_model(m, n_iters)
    got = TC.connected_components(torch.from_numpy(m), n_iters)  # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(JK.connected_components(jnp.asarray(m), n_iters=n_iters))
    assert np.argwhere(ref != want).tolist() == [[0, 3600, 1]]  # the reference's int32 quirk, recorded


@pytest.mark.parametrize("case", ["random45", "rows_of_background"])
def test_plain_labels_are_exact_at_1080p(case):
    rng = np.random.default_rng(3)
    m = rng.uniform(size=(1, 1080, 1920)) < 0.45
    if case == "rows_of_background":
        # long foreground runs broken by single background pixels, so a
        # row's last pixels follow ~1,900 segment starts
        m = rng.uniform(size=(1, 1080, 1920)) < 0.97
        m[:, ::7, ::2] = False
    assert (1920 + 1) * (1080 * 1920 + 1) >= 2**31  # beyond the reference's int32 offsets
    np.testing.assert_array_equal(TK.connected_components(torch.from_numpy(m), 4).numpy(), _labels_model(m, 4))


@pytest.mark.parametrize("n_iters", [0, 1, 3])
def test_model_equals_the_reference_where_it_is_exact(rng, n_iters):
    m = rng.uniform(size=(2, 40, 72)) < 0.6
    np.testing.assert_array_equal(_labels_model(m, n_iters), np.asarray(JK.connected_components(jnp.asarray(m), n_iters=n_iters)))
