"""The bootstrap's stereo scores in one batched pass
(caliscope_tpu_torch/solvers/pose_network.py::stereo_rmse_batch) held to
the single-pair rule it replaced (tests/torch_pair_scores_common.py), pair
by pair, in float64 on the CPU.

Scenes: the port's default_ring_scene(4, 20) (every camera sees every
point) and sparse_coverage_scene() (6 cameras, culled: distant pairs share
few points or none), the ring with rows repeated, cut down and given
fisheye lenses, and the markerless ring of the epipolar bootstrap. The
batch sums a pair's squares in another order than numpy's mean does, so a
score may move in its last bits: 1e-12 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import caliscope_tpu_torch.solvers.epipolar as PE
import caliscope_tpu_torch.solvers.pose_network as TP
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import default_ring_scene, sparse_coverage_scene
from torch_pair_scores_common import per_pair_stereo_rmse
from torch_pose_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-12


def rows_of(ip, idx):
    """ImagePoints made of ip's rows `idx`, in that order (repeats kept)."""
    ft = None if ip.frame_time is None else ip.frame_time[idx]
    return ImagePoints(ip.sync_index[idx], ip.cam_id[idx], ip.object_id[idx], ip.keypoint_id[idx], ip.img_xy[idx],
                       ip.obj_loc[idx], ft)


@pytest.fixture(scope="module")
def scenes():
    """name -> (image points, unposed cameras, aggregated pairs)."""
    out = {}
    for name, scene in (("ring", default_ring_scene(4, 20)), ("sparse", sparse_coverage_scene())):
        ip, cams = scene.image_points_noisy(), strip_extrinsics(scene.cameras)
        poses = TP.estimate_camera_object_poses(ip, cams, device="cpu")
        out[name] = (ip, cams, TP.aggregate_pairs(TP.reject_outliers(TP.relative_pose_samples(poses))))
    return out


def with_inverses(pairs):
    """Each pair and its inverse, so that either camera is camera A."""
    return [sp for p in pairs.values() for sp in (p, p.inverted())]


def assert_scores_are_the_rule(pairs, ip, cams):
    got = TP.stereo_rmse_batch(pairs, ip, cams, device="cpu")
    assert sorted(got) == sorted(sp.pair for sp in pairs)
    for sp in pairs:
        want = per_pair_stereo_rmse(sp, ip, cams, device="cpu")
        if np.isnan(want):
            assert np.isnan(got[sp.pair]), sp.pair
        else:
            assert got[sp.pair] == pytest.approx(want, rel=REL, abs=0), sp.pair
    return got


@pytest.mark.parametrize("name", ["ring", "sparse"])
def test_the_batch_is_the_per_pair_rule(scenes, name):
    ip, cams, pairs = scenes[name]
    got = assert_scores_are_the_rule(with_inverses(pairs), ip, cams)
    assert all(0.0 < got[key] < 5.0 for key in pairs)
    assert TP.stereo_rmse(pairs[next(iter(pairs))], ip, cams, device="cpu") == got[next(iter(pairs))]


def test_a_point_with_three_rows_in_a_pair_scores_as_before(scenes):
    """Rows repeated with a shifted pixel: a point then has three or four
    rows in a pair, its first two (in the rows' order) may both be one
    camera's, and every row of it is scored."""
    ip, cams, pairs = scenes["ring"]
    rng = np.random.default_rng(5)
    n = len(ip)
    extra = rng.choice(n, 60, replace=False)
    order = np.concatenate([np.arange(n), extra])
    rng.shuffle(order)  # a repeat may come before or after the row it repeats
    dup = rows_of(ip, order)
    dup.img_xy[np.isin(order, extra) & (np.arange(len(order)) % 2 == 0)] += 0.7
    keys = np.stack([dup.sync_index, dup.cam_id, dup.object_id, dup.keypoint_id], axis=1)
    assert len(np.unique(keys, axis=0)) == n
    assert_scores_are_the_rule(with_inverses(pairs), dup, cams)


def test_a_pair_with_fewer_than_ten_rows_is_nan(scenes):
    """Camera 3 sees only 4 or 5 points that cameras 0 and 1 see: 8 rows
    in a pair score nan, 9 (one of camera 3's rows repeated) nan, 10 a
    number."""
    ip, cams, pairs = scenes["ring"]
    for keep_points, repeat, finite in ((4, False, False), (4, True, False), (5, False, True)):
        first = ip.sync_index == ip.sync_index.min()
        some = first & (ip.keypoint_id < keep_points)
        idx = np.flatnonzero((ip.cam_id != 3) | some)
        if repeat:
            idx = np.append(idx, np.flatnonzero((ip.cam_id == 3) & some)[0])
        sel = rows_of(ip, idx)
        got = assert_scores_are_the_rule(with_inverses(pairs), sel, cams)
        for key in ((0, 3), (1, 3), (3, 0)):
            assert np.isfinite(got[key]) == finite, key
        assert np.isfinite(got[(0, 1)])
    empty = rows_of(ip, np.flatnonzero(ip.cam_id == 0))
    assert np.isnan(TP.stereo_rmse(pairs[(0, 1)], empty, cams, device="cpu"))


def test_a_mixed_rig_undistorts_both_cameras_with_camera_as_flag(scenes):
    """Cameras 1 and 3 fisheye (four coefficients), 0 and 2 Brown: each
    pair and its inverse undistort both cameras' rows with their camera A's
    model, so a mixed pair scores differently either way round."""
    ip, cams, pairs = scenes["ring"]
    mixed = cams.copy()
    for cid in (1, 3):
        mixed.cameras[cid].fisheye = True
        mixed.cameras[cid].distortions = np.array([0.02, -0.01, 0.004, 0.0])
    got = assert_scores_are_the_rule(with_inverses(pairs), ip, mixed)
    assert got[(0, 1)] != pytest.approx(got[(1, 0)], rel=1e-6)


def test_one_device_read_for_all_pairs_and_chunks(scenes, monkeypatch):
    """The sums come back once, whatever the chunks: one Tensor.cpu call."""
    ip, cams, pairs = scenes["sparse"]
    want = TP.stereo_rmse_batch(list(pairs.values()), ip, cams, device="cpu")
    reads = []
    to_cpu = torch.Tensor.cpu

    def counted(t, *args, **kwargs):
        reads.append(1)
        return to_cpu(t, *args, **kwargs)

    monkeypatch.setattr(TP, "SCORE_CHUNK", 37)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    got = TP.stereo_rmse_batch(list(pairs.values()), ip, cams, device="cpu")
    monkeypatch.undo()
    assert len(reads) == 1
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=REL, abs=0) or (np.isnan(value) and np.isnan(got[key]))


def per_pair_batch(pairs, ip, cams, device=None):
    return {sp.pair: per_pair_stereo_rmse(sp, ip, cams, device=device) for sp in pairs}


def assert_same_network(got, want):
    """The same pairs and scores; each pair's pose the same up to roundoff:
    two bridges that chain the same pairs in another association score the
    same sum of errors, so the last bit of a score may pick the other."""
    assert sorted(got.pairs) == sorted(want.pairs)
    for key, sp in want.pairs.items():
        assert got.pairs[key].error_score == pytest.approx(sp.error_score, rel=REL, abs=0), key
        np.testing.assert_allclose(got.pairs[key].rotation, sp.rotation, rtol=0, atol=REL)
        np.testing.assert_allclose(got.pairs[key].translation, sp.translation, rtol=0, atol=REL)


def test_the_pnp_network_and_its_anchor_are_as_before(scenes, monkeypatch):
    """build_pnp_pose_network on the sparse scene (bridged pairs) with the
    batch and with the per-pair rule: the same pairs, scores, bridges and
    anchor."""
    ip, cams, _ = scenes["sparse"]
    got = TP.build_pnp_pose_network(ip, cams, device="cpu")
    monkeypatch.setattr(TP, "stereo_rmse_batch", per_pair_batch)
    want = TP.build_pnp_pose_network(ip, cams, device="cpu")
    assert_same_network(got, want)
    assert got.apply_to(cams.copy()) == want.apply_to(cams.copy())


def test_the_epipolar_path_scores_as_before(monkeypatch):
    """The markerless bootstrap's anchor-relative pairs, scored in one
    batch, against the per-pair rule on the same RANSAC draws."""
    scene = default_ring_scene(noise_sigma_px=0.5, n_frames=25)
    ip = scene.image_points_noisy()
    ip = ImagePoints(ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id, ip.img_xy,
                     np.full((len(ip), 3), np.nan), ip.frame_time)
    cams = strip_extrinsics(scene.cameras)
    got = PE.build_epipolar_pose_network(ip, cams, device="cpu")
    monkeypatch.setattr(PE, "stereo_rmse_batch", per_pair_batch)
    want = PE.build_epipolar_pose_network(ip, cams, device="cpu")
    assert_same_network(got, want)
    assert all(sp.error_score < 5.0 for sp in want.pairs.values())
