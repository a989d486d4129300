"""The port's zero-phase filter (caliscope_tpu_torch/ops/signal.py), gap
filling and trajectory smoothing (caliscope_tpu_torch/observations.py)
held against the JAX package's on the same numpy inputs.

JAX runs in x64, the port in float64 on the CPU. The Butterworth design is
the same host arithmetic, so it must be equal. The port solves the IIR in
closed form (a banded triangular system, in blocks of ops/signal.BLOCK
samples) where the JAX package scans the recurrence: the same equations
summed in another order, so filtfilt and smooth are held to 1e-10 (seen:
~1e-13 on 2,500 samples). Gap filling is the same integer and float64
arithmetic row for row: the same rows in the same order, values within
1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import caliscope_tpu.observations as JO
import caliscope_tpu.ops.signal as JS

import caliscope_tpu_torch.observations as TO
import caliscope_tpu_torch.ops.signal as TS
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FILTER_TOL = 1e-10
FILL_TOL = 1e-12


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("cutoff, fs", [(6.0, 30.0), (4.0, 120.0), (0.5, 25.0)])
def test_butter_lowpass_is_the_jax_packages(order, cutoff, fs):
    jb, ja = JS.butter_lowpass(cutoff, fs, order)
    tb, ta = TS.butter_lowpass(cutoff, fs, order)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(TS._lfilter_zi(tb, ta), JS._lfilter_zi(jb, ja))


def test_butter_lowpass_rejects_cutoffs_outside_nyquist():
    with pytest.raises(ValueError, match="Normalized cutoff"):
        TS.butter_lowpass(20.0, 30.0)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("extra", [1, 2, 37, 2500])
def test_filtfilt_matches_jax_from_the_padlen_edge_up(order, extra):
    """Lengths padlen + 1 (the shortest accepted) up to 2,500 samples, past
    one block of the closed-form solve; several columns at once."""
    b, a = JS.butter_lowpass(6.0, 30.0, order)
    n = 3 * (order + 1) + extra
    x = np.random.default_rng(extra).normal(size=(n, 4)).cumsum(axis=0)
    want = np.asarray(JS.filtfilt(b, a, x))
    got = TS.filtfilt(b, a, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FILTER_TOL, rtol=0)


def test_filtfilt_one_dimensional_other_axis_and_padlen_refusal():
    b, a = JS.butter_lowpass(6.0, 30.0, 2)
    rng = np.random.default_rng(5)
    x = rng.normal(size=40)
    np.testing.assert_allclose(TS.filtfilt(b, a, torch.as_tensor(x)).numpy(), np.asarray(JS.filtfilt(b, a, x)),
                               atol=FILTER_TOL, rtol=0)
    x2 = rng.normal(size=(3, 40))
    np.testing.assert_allclose(TS.filtfilt(b, a, torch.as_tensor(x2), axis=1).numpy(),
                               np.asarray(JS.filtfilt(b, a, x2, axis=1)), atol=FILTER_TOL, rtol=0)
    with pytest.raises(ValueError, match="must exceed padlen 9"):
        TS.filtfilt(b, a, torch.as_tensor(x[:9]))


@pytest.mark.parametrize("n", [1, 2, 1500])
def test_lfilter_with_initial_state_matches_jax(n):
    b, a = JS.butter_lowpass(5.0, 30.0, 3)
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 2))
    zi = rng.normal(size=(3, 2))
    want = np.asarray(JS.lfilter(b, a, x, zi))
    got = TS.lfilter(b, a, torch.as_tensor(x), torch.as_tensor(zi)).numpy()
    np.testing.assert_allclose(got, want, atol=FILTER_TOL, rtol=0)


def ragged_tracks(seed: int, n_cams: int = 3, n_kp: int = 6, n_sync: int = 80):
    """(sync, cam, obj, kp) rows of ragged tracks with gaps of every width,
    in shuffled order; two objects; a few duplicate observations."""
    rng = np.random.default_rng(seed)
    rows = []
    for cam in range(n_cams):
        for obj in (0, 3):
            for kp in range(n_kp):
                n = int(rng.integers(1, n_sync // 2))
                rows += [(s, cam, obj, kp) for s in np.sort(rng.choice(n_sync, n, replace=False))]
    rows = np.array(rows)
    rows = np.concatenate([rows, rows[rng.choice(len(rows), 4, replace=False)]])
    return rows[rng.permutation(len(rows))], rng


@pytest.mark.parametrize("with_time", [False, True])
@pytest.mark.parametrize("max_gap", [0, 1, 3, 7])
def test_image_points_fill_gaps_matches_jax(with_time, max_gap):
    """Same rows in the same order (the final lexsort), values within 1e-12;
    obj_loc carried from a track's first row when it has one; frame_time
    dropped once a row is filled, as the JAX package drops it."""
    rows, rng = ragged_tracks(max_gap)
    xy = rng.uniform(0, 1920, (len(rows), 2))
    obj_loc = np.where((rows[:, 3] % 3 == 0)[:, None], rng.normal(size=(len(rows), 3)), np.nan)
    obj_loc[rows[:, 3] == 1] = [0.1, 0.2, 0.0]
    ft = rng.uniform(size=len(rows)) if with_time else None
    args = (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], xy, obj_loc, ft)
    want = JO.ImagePoints(*args).fill_gaps(max_gap)
    got = TO.ImagePoints(*args).fill_gaps(max_gap)
    if max_gap:
        assert len(want) > len(rows)
    for f in ("sync_index", "cam_id", "object_id", "keypoint_id"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.img_xy, want.img_xy, atol=FILL_TOL, rtol=0)
    np.testing.assert_allclose(got.obj_loc, want.obj_loc, atol=FILL_TOL, rtol=0)
    assert (got.frame_time is None) == (want.frame_time is None)
    if want.frame_time is not None:
        np.testing.assert_array_equal(got.frame_time, want.frame_time)


def world_tracks(seed: int):
    rows, rng = ragged_tracks(seed, n_cams=1, n_kp=9, n_sync=120)
    rows = rows[np.unique(rows[:, [0, 2, 3]], axis=0, return_index=True)[1]]  # one row per key
    rows = rows[rng.permutation(len(rows))]
    sync = rows[:, 0].copy()
    sync[:5] = JO.STATIC_SYNC_INDEX
    return sync, rows[:, 2], rows[:, 3], rng.normal(size=(len(rows), 3)), rng.uniform(size=len(rows))


@pytest.mark.parametrize("max_gap", [0, 2, 5])
def test_world_points_fill_gaps_matches_jax(max_gap):
    """xyz and frame_time interpolated, static rows never filled, the same
    rows in the same order."""
    args = world_tracks(max_gap)
    want = JO.WorldPoints(*args).fill_gaps(max_gap)
    got = TO.WorldPoints(*args).fill_gaps(max_gap)
    for f in ("sync_index", "object_id", "keypoint_id"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.xyz, want.xyz, atol=FILL_TOL, rtol=0)
    np.testing.assert_allclose(got.frame_time, want.frame_time, atol=FILL_TOL, rtol=0)
    assert (got.sync_index == JO.STATIC_SYNC_INDEX).sum() == 5


def test_fill_gaps_on_empty_points_is_a_no_op():
    assert len(TO.ImagePoints.empty().fill_gaps(3)) == 0
    assert len(TO.WorldPoints.empty().fill_gaps(3)) == 0


@pytest.mark.parametrize("fps, cutoff", [(30.0, 6.0), (60.0, 4.0)])
def test_smooth_matches_jax_on_ragged_tracks(fps, cutoff):
    """Tracks of many lengths (some too short to filter, left as they are),
    filled first so most are long; static rows untouched."""
    wp = world_tracks(11)
    want = JO.WorldPoints(*wp).fill_gaps(4).smooth(fps, cutoff)
    port = TO.WorldPoints(*wp).fill_gaps(4)
    got = port.smooth(fps, cutoff, device="cpu")
    np.testing.assert_allclose(got.xyz, want.xyz, atol=FILTER_TOL, rtol=0)
    static = port.sync_index == TO.STATIC_SYNC_INDEX
    np.testing.assert_array_equal(got.xyz[static], port.xyz[static])
    assert not np.array_equal(got.xyz[~static], port.xyz[~static])
    for f in ("sync_index", "object_id", "keypoint_id", "frame_time"):
        np.testing.assert_array_equal(getattr(got, f), getattr(port, f))


def test_smooth_leaves_short_tracks_and_empty_points():
    xyz = np.array([[1, 1, 1], [2, 2, 2], [3, 3, 3]], float)
    wp = TO.WorldPoints(np.array([TO.STATIC_SYNC_INDEX, 0, 1]), np.zeros(3), np.zeros(3), xyz.copy())
    np.testing.assert_array_equal(wp.smooth(30.0, device="cpu").xyz, xyz)
    assert len(TO.WorldPoints.empty().smooth(30.0, device="cpu")) == 0
