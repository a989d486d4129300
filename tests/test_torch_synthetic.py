"""The port's synthetic scene engine (caliscope_tpu_torch/synthetic/) held
against caliscope_tpu/synthetic/: every factory's scene, the rig builders,
the SE(3) value type and fault injection.

Both engines project through their own package's projection (float64), so
img_xy agrees to roundoff, IMG_TOL = 1e-9 px (differences seen: ~5e-13);
integer columns, visibility (which rows exist), obj_loc and the seeded
noise must be equal exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import caliscope_tpu.synthetic as JS
import caliscope_tpu.synthetic.camera_synthesizer as JC
import caliscope_tpu.synthetic.factories as JF
import caliscope_tpu.synthetic.faults as JFa
import caliscope_tpu_torch.synthetic as TS
import caliscope_tpu_torch.synthetic.camera_synthesizer as TC
import caliscope_tpu_torch.synthetic.factories as TF
import caliscope_tpu_torch.synthetic.faults as TFa

IMG_TOL = 1e-9
KEY_COLUMNS = ("sync_index", "cam_id", "object_id", "keypoint_id")


def assert_same_points(port, jax):
    assert len(port) == len(jax)
    for col in KEY_COLUMNS:
        np.testing.assert_array_equal(getattr(port, col), getattr(jax, col))
    np.testing.assert_allclose(port.img_xy, jax.img_xy, atol=IMG_TOL, rtol=0)
    np.testing.assert_array_equal(port.obj_loc, jax.obj_loc)


def assert_same_cameras(port, jax):
    assert list(port.cameras) == list(jax.cameras)
    for cid, jc in jax.cameras.items():
        tc = port.cameras[cid]
        assert tc.size == jc.size and tc.fisheye == jc.fisheye
        for field in ("matrix", "distortions", "rotation", "translation"):
            a, b = getattr(tc, field), getattr(jc, field)
            assert (a is None) == (b is None), field
            if b is not None:
                np.testing.assert_allclose(a, b, atol=1e-15, rtol=0)


FACTORIES = [
    ("default_ring_scene", {}),
    ("default_ring_scene", {"n_cameras": 8, "n_frames": 12, "seed": 3}),
    ("ring_with_static_markers", {}),
    ("two_sided_ring_scene", {"n_frames": 12}),
    ("narrow_baseline_scene", {"n_frames": 10}),
    ("depth_varied_scene", {"n_frames": 12}),
    ("sparse_coverage_scene", {"n_frames": 16}),
]


@pytest.mark.parametrize("name,kwargs", FACTORIES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(FACTORIES)])
def test_factory_scene_matches_jax(name, kwargs):
    js, ts = getattr(JF, name)(**kwargs), getattr(TF, name)(**kwargs)
    if name == "two_sided_ring_scene":
        (js, jch), (ts, tch) = js, ts
        np.testing.assert_array_equal(tch.object_corners(1), jch.object_corners(1))
    assert_same_cameras(ts.cameras, js.cameras)
    assert_same_points(ts.image_points_noisy(), js.image_points_noisy())
    assert_same_points(ts.image_points_perfect(), js.image_points_perfect())
    tw, jw = ts.world_points(), js.world_points()
    np.testing.assert_array_equal(tw.keys(), jw.keys())
    np.testing.assert_allclose(tw.xyz, jw.xyz, atol=1e-15)
    assert ts.static_object_ids() == js.static_object_ids()
    assert ts.n_frames == js.n_frames


def test_noise_override_and_coverage_match_jax():
    js, ts = JF.default_ring_scene(n_frames=8), TF.default_ring_scene(n_frames=8)
    assert_same_points(ts.image_points_noisy(sigma_px=2.0, seed=5), js.image_points_noisy(sigma_px=2.0, seed=5))
    np.testing.assert_array_equal(ts.coverage_matrix(), js.coverage_matrix())


def test_rig_builders_match_jax():
    for lens in ("webcam", "machine_vision", "gopro_like_fisheye"):
        jl, tl = getattr(JC.LensProfile, lens)(), getattr(TC.LensProfile, lens)()
        assert dataclasses.astuple(jl) == dataclasses.astuple(tl)
        np.testing.assert_array_equal(tl.make_matrix(), jl.make_matrix())
    jb = JC.CameraSynthesizer().add_ring(3, start_angle=0.3).add_line(2).add_camera_at([0.5, -2.0, 1.5]).build()
    tb = TC.CameraSynthesizer().add_ring(3, start_angle=0.3).add_line(2).add_camera_at([0.5, -2.0, 1.5]).build()
    assert_same_cameras(tb, jb)
    assert_same_cameras(
        TC.perturb_intrinsics(tb, np.random.default_rng(4)), JC.perturb_intrinsics(jb, np.random.default_rng(4))
    )
    assert_same_cameras(TC.strip_intrinsics(tb), JC.strip_intrinsics(jb))
    assert_same_cameras(TC.strip_extrinsics(tb), JC.strip_extrinsics(jb))


def test_se3_pose_matches_jax(rng):
    for _ in range(3):
        axis, angle, tr = rng.normal(size=3), rng.uniform(0, np.pi), rng.normal(size=3)
        jp, tp = JS.SE3Pose.from_axis_angle(axis, angle, tr), TS.SE3Pose.from_axis_angle(axis, angle, tr)
        jq = JS.SE3Pose.look_at(rng.normal(size=3) * 2, np.zeros(3))
        tq = TS.SE3Pose(jq.rotation, jq.translation)
        for got, want in (
            (tp, jp),
            (tp.compose(tq), jp.compose(jq)),
            (tp.inverse(), jp.inverse()),
            (tp.with_roll(0.3).with_pitch(-0.2), jp.with_roll(0.3).with_pitch(-0.2)),
            (TS.SE3Pose.look_at([2.0, 0.0, 1.0], [0.0, 0.0, 0.0]), JS.SE3Pose.look_at([2.0, 0.0, 1.0], [0.0, 0.0, 0.0])),
        ):
            np.testing.assert_allclose(got.matrix, want.matrix, atol=1e-15)
        np.testing.assert_allclose(tp.rvec, jp.rvec, atol=1e-15)
        X = rng.normal(size=(5, 3))
        np.testing.assert_allclose(tp.apply(X), jp.apply(X), atol=1e-15)
    jt = JS.Trajectory.linear(5, tilt_amplitude=0.2)
    tt = TS.Trajectory.linear(5, tilt_amplitude=0.2)
    for a, b in zip(tt.poses, jt.poses):
        np.testing.assert_allclose(a.matrix, b.matrix, atol=1e-15)
    assert len(TS.Trajectory.stationary(4)) == 4


def test_fault_injection_matches_jax():
    js, ts = JF.default_ring_scene(n_frames=10), TF.default_ring_scene(n_frames=10)
    jip, tip = js.image_points_noisy(), ts.image_points_noisy()
    jo, jmask = JFa.inject_outliers(jip, 0.05, 40.0, np.random.default_rng(1))
    to, tmask = TFa.inject_outliers(tip, 0.05, 40.0, np.random.default_rng(1))
    np.testing.assert_array_equal(tmask, jmask)
    assert_same_points(to, jo)
    kw = dict(dropout=0.1, occlusions=[(1, 2, 5)], killed_pairs=[(0, 2)], seed=3)
    assert_same_points(TFa.VisibilityFilter(**kw).apply(tip), JFa.VisibilityFilter(**kw).apply(jip))

