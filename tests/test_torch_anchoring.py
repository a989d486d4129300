"""Anchoring and scale QA on the port's CaptureVolume (`scaled` with each
cue type and pooled cues, `oriented`, `grounded`,
`compute_volumetric_scale_accuracy`) held against the JAX package's on one
volume carried across with `convert`, within 1e-12; and the synthetic
fixture repository's round trip.

The volume is default_ring_scene(4, 8)'s truth (cameras, noisy image
points, true world points) moved by a similarity of scale 0.5, so scaling,
orienting and grounding each have work to do. Anchoring is host float64
arithmetic on both sides.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

from caliscope_tpu.ops.similarity import SimilarityParams as JaxSimilarity
from caliscope_tpu.scale import CameraDistance as JCD
from caliscope_tpu.scale import DepthObservation as JDO
from caliscope_tpu.scale import SegmentLength as JSL
from caliscope_tpu.synthetic.factories import default_ring_scene as j_ring
from caliscope_tpu.synthetic.fixture_repository import save_scene_fixture as j_save_fixture
from caliscope_tpu.volume import CaptureVolume as JaxVolume

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.scale import CameraDistance, DepthObservation, SegmentLength
from caliscope_tpu_torch.synthetic.factories import default_ring_scene
from caliscope_tpu_torch.synthetic.fixture_repository import (
    load_fixture_observations,
    load_scene_fixture,
    save_scene_fixture,
)
from caliscope_tpu_torch.volume import CaptureVolume

ATOL = 1e-12
ROT = np.array([[0.0, -1.0, 0.0], [0.6, 0.0, -0.8], [0.8, 0.0, 0.6]])


@pytest.fixture(scope="module")
def volumes():
    scene = j_ring(n_cameras=4, n_frames=8)
    jv = JaxVolume(scene.cameras, scene.image_points_noisy(), scene.world_points())
    jv = jv._apply_similarity(JaxSimilarity(0.5, ROT, np.array([0.3, -0.2, 0.1])))
    cams = {cid: {f: getattr(c, f) for f in convert.CAMERA_FIELDS} for cid, c in jv.camera_array.cameras.items()}
    ip = {f: getattr(jv.image_points, f) for f in convert.IMAGE_POINT_FIELDS}
    wp = {f: getattr(jv.world_points, f) for f in convert.WORLD_POINT_FIELDS}
    tv = CaptureVolume(convert.camera_array(cams), convert.image_points(ip), convert.world_points(wp), device="cpu")
    return jv, tv


def _same_volume(got, want):
    assert sorted(got.camera_array.cameras) == sorted(want.camera_array.cameras)
    for cid, w in want.camera_array.cameras.items():
        g = got.camera_array.cameras[cid]
        np.testing.assert_allclose(g.rotation, w.rotation, rtol=0, atol=ATOL)
        np.testing.assert_allclose(g.translation, w.translation, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.world_points.xyz, want.world_points.xyz, rtol=0, atol=ATOL)


def _both(fn_jax, fn_port):
    """Run both, returning (jax result, port result, jax warnings, port warnings)."""
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = fn_jax()
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = fn_port()
    return want, got, [str(w.message) for w in wj], [str(w.message) for w in wt]


def _cues(mod_cd, mod_sl, mod_do, wp):
    """Cue sets by name, built from the given package's cue types."""
    s0, k0 = int(wp.sync_index[0]), int(wp.keypoint_id[0])
    return {
        "camera_distance": [mod_cd(0, 1, meters=2.0 * np.sqrt(2.0))],
        "segment_length": [mod_sl(0, 6, meters=0.324)],
        "depth": [mod_do(2, s0, k0, depth_m=2.0), mod_do(3, s0, k0, depth_m=2.1, sigma_m=0.1)],
        "pooled": [mod_cd(0, 2, meters=4.0, sigma_m=0.02), mod_sl(0, 1, meters=0.054), mod_do(1, s0, k0, depth_m=2.0)],
        "disagreeing": [mod_cd(0, 1, meters=1.0, sigma_m=0.001), mod_cd(1, 2, meters=10.0, sigma_m=0.001)],
        "dropped_depth": [
            mod_do(0, s0, k0, depth_m=2.0),
            mod_do(9, s0, k0, depth_m=2.0),  # no such camera
            mod_do(0, 10_000, k0, depth_m=2.0),  # not triangulated at that sync
        ],
    }


@pytest.mark.parametrize("name", ["camera_distance", "segment_length", "depth", "pooled", "disagreeing", "dropped_depth"])
def test_scaled_matches_jax(volumes, name):
    jv, tv = volumes
    jcues = _cues(JCD, JSL, JDO, jv.world_points)[name]
    tcues = _cues(CameraDistance, SegmentLength, DepthObservation, tv.world_points)[name]
    want, got, wj, wt = _both(lambda: jv.scaled(*jcues), lambda: tv.scaled(*tcues))
    _same_volume(got, want)
    assert wt == wj
    if name == "disagreeing":
        assert len(wt) == 1 and "disagree" in wt[0]
    if name == "dropped_depth":
        assert len(wt) == 1 and wt[0].startswith("Ignored 2 of 3 depth cues")
    if name == "camera_distance":  # the ring's cameras 0 and 1 are 2 sqrt(2) m apart
        c = [-cam.rotation.T @ cam.translation for cam in (got.camera_array.cameras[i] for i in (0, 1))]
        assert np.linalg.norm(c[0] - c[1]) == pytest.approx(2.0 * np.sqrt(2.0), rel=1e-9)


def test_scaled_refusals_match_jax(volumes):
    jv, tv = volumes
    for args_j, args_t, err in [
        ((), (), ValueError),
        ((JDO(9, 0, 0, 1.0),), (DepthObservation(9, 0, 0, 1.0),), ValueError),
        ((JSL(0, 10_000, 1.0),), (SegmentLength(0, 10_000, 1.0),), ValueError),
        ((JCD(0, 0, 1.0),), (CameraDistance(0, 0, 1.0),), ValueError),
        (("cue",), ("cue",), TypeError),
    ]:
        with pytest.raises(err) as ej, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jv.scaled(*args_j)
        with pytest.raises(err) as et, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tv.scaled(*args_t)
        assert str(et.value) == str(ej.value)


def test_oriented_and_grounded_match_jax(volumes):
    jv, tv = volumes
    up = {cid: cam.rotation @ (ROT @ np.array([0.0, 0.0, 1.0])) for cid, cam in jv.camera_array.cameras.items()}
    up[2] = up[2] + np.array([0.05, -0.02, 0.0])  # one camera's estimate a little off
    want, got, _, _ = _both(lambda: jv.oriented(up), lambda: tv.oriented(up))
    _same_volume(got, want)
    want_g, got_g, _, _ = _both(lambda: want.grounded(), lambda: got.grounded(lowest_point_height_m=0.0))
    _same_volume(got_g, want_g)
    assert np.percentile(got_g.world_points.xyz[:, 2], 1.0, method="lower") == pytest.approx(0.0, abs=1e-12)
    want_h, got_h, _, _ = _both(lambda: jv.grounded(lowest_point_height_m=0.1), lambda: tv.grounded(lowest_point_height_m=0.1))
    _same_volume(got_h, want_h)
    assert tv._anchor_cam_id() == jv._anchor_cam_id() == 0
    for bad in ({}, {7: np.array([0.0, 0.0, 1.0])}):
        with pytest.raises(ValueError):
            tv.oriented(bad)
    with pytest.raises(ValueError, match="lowest_point"):
        tv.grounded("floor_plane")


def test_volumetric_scale_accuracy_matches_jax(volumes):
    jv, tv = volumes
    for j, t in ((jv, tv), (jv.scaled(JCD(0, 1, 2.0 * np.sqrt(2.0))), tv.scaled(CameraDistance(0, 1, 2.0 * np.sqrt(2.0))))):
        want, got = j.compute_volumetric_scale_accuracy(), t.compute_volumetric_scale_accuracy()
        assert got.n_frames_sampled == want.n_frames_sampled > 0
        assert got.static_object_ids == want.static_object_ids
        for g, w in zip(got.frame_errors, want.frame_errors):
            gd, wd = g.__dict__, w.__dict__
            assert gd.keys() == wd.keys()
            for k in gd:
                assert gd[k] == pytest.approx(wd[k], rel=0, abs=ATOL * 1e3), k  # millimetres
        for prop in ("pooled_rmse_mm", "median_rmse_mm", "max_rmse_mm", "mean_signed_error_mm"):
            assert getattr(got, prop) == pytest.approx(getattr(want, prop), rel=0, abs=ATOL * 1e3)
    # after scaling by the true baseline the true points are metric again
    assert got.pooled_rmse_mm < 1e-6


def test_fixture_repository_round_trip(tmp_path):
    """The persisted tables reload bit for bit, the scene's geometry and
    trajectories exactly; the reloaded scene regenerates its tables to
    roundoff (its camera rotations pass through Rodrigues vectors in
    camera_array.toml). The port also reads a fixture the JAX package saved."""
    scene = default_ring_scene(n_cameras=3, n_frames=4)
    save_scene_fixture(scene, tmp_path / "port")
    back = load_scene_fixture(tmp_path / "port")
    assert (back.noise_sigma_px, back.seed, len(back.objects)) == (scene.noise_sigma_px, scene.seed, len(scene.objects))
    perfect, noisy, world = load_fixture_observations(tmp_path / "port")
    for table, original, regenerated in (
        (perfect, scene.image_points_perfect(), back.image_points_perfect()),
        (noisy, scene.image_points_noisy(), back.image_points_noisy()),
    ):
        for f in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy"):
            np.testing.assert_array_equal(getattr(table, f), getattr(original, f))
        np.testing.assert_allclose(table.img_xy, regenerated.img_xy, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(world.xyz, scene.world_points().xyz)
    for o, so in zip(back.objects, scene.objects):
        np.testing.assert_array_equal(o.points_local, so.points_local)
        assert (o.object_id, o.static) == (so.object_id, so.static)
    for tr, st in zip(back.trajectories, scene.trajectories):
        np.testing.assert_array_equal(np.stack([p.rotation for p in tr.poses]), np.stack([p.rotation for p in st.poses]))

    j_scene = j_ring(n_cameras=3, n_frames=4)
    j_save_fixture(j_scene, tmp_path / "jax")
    from_jax = load_scene_fixture(tmp_path / "jax")
    for o, jo in zip(from_jax.objects, j_scene.objects):
        np.testing.assert_array_equal(o.points_local, jo.points_local)
    for tr, jtr in zip(from_jax.trajectories, j_scene.trajectories):
        for p, jp in zip(tr.poses, jtr.poses):
            np.testing.assert_array_equal(p.rotation, jp.rotation)
            np.testing.assert_array_equal(p.translation, jp.translation)
    np.testing.assert_allclose(from_jax.image_points_perfect().img_xy, j_scene.image_points_perfect().img_xy, rtol=0, atol=1e-9)
