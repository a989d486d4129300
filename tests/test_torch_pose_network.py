"""The port's pose-network bootstrap (caliscope_tpu_torch/solvers/
pose_network.py, CaptureVolume.bootstrap and its outlier-camera repair)
held against the JAX package's, stage by stage.

Inputs: the JAX package's default_ring_scene(4, 20) and
sparse_coverage_scene() (6 cameras, culled, chained co-visibility), carried
to the port as numpy arrays (tests/torch_pose_common.py), so both packages
see the same bits. The JAX package runs in x64, the port in float64 on the
CPU. Tolerances: resections 1e-8 (poses as rotation matrices: an rvec
near pi may come out as its antipodal twin); the numpy graph algebra is
the JAX package's own numpy path op for op, 1e-12; anything downstream of
a triangulation or stereo score 1e-9. RANSAC-driven steps (scaffold,
repair) are held on the JAX package's own samples, and on the port's own
samples where clean data makes every hypothesis find the same inliers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import caliscope_tpu.solvers.pose_network as JP
from caliscope_tpu.ops import lie as JL
from caliscope_tpu.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu.synthetic.factories import default_ring_scene, sparse_coverage_scene
from caliscope_tpu.volume import CaptureVolume as JaxVolume
from caliscope_tpu.volume import _repair_bootstrap_outlier_cameras as jax_repair

import caliscope_tpu_torch.ops.epipolar as TE
import caliscope_tpu_torch.solvers.pose_network as TP
from caliscope_tpu_torch import convert
from caliscope_tpu_torch.ops import lie as TL
from caliscope_tpu_torch.volume import CaptureVolume as PortVolume
from caliscope_tpu_torch.volume import _repair_bootstrap_outlier_cameras as port_repair
from torch_pose_common import (
    assert_same_rig,
    jax_sample_indices,
    network_pairs,
    port_cameras,
    port_points,
    port_world,
)

RESECTION_TOL = 1e-8
HOST_TOL = 1e-12
GEOM_TOL = 1e-9


def partial_view(ip, cam_id: int = 3, keep_keypoints: int = 3):
    """`cam_id` sees only keypoints 0..keep_keypoints-1 of the board: too few
    for a resection of its own (min 4), so the pose network cannot place it,
    but its rows still join the other cameras' cloud."""
    return ip.select((ip.cam_id != cam_id) | (ip.keypoint_id < keep_keypoints))


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX image points, JAX unposed cameras, port twins)."""
    out = {}
    for name, scene in (("ring", default_ring_scene(4, 20)), ("sparse", sparse_coverage_scene())):
        ip, cams = scene.image_points_noisy(), strip_extrinsics(scene.cameras)
        out[name] = (ip, cams, port_points(ip), port_cameras(cams))
    ip, cams, _, pcams = out["ring"]
    part = partial_view(ip)
    out["partial"] = (part, cams, port_points(part), pcams)
    return out


@pytest.fixture(scope="module")
def jax_runs(scenes):
    """The JAX package's network and bootstrap per scene, each computed once
    (its first calls compile for tens of seconds)."""
    cache = {}

    def get(kind, name):
        if (kind, name) not in cache:
            ip, cams, _, _ = scenes[name]
            fn = JP.build_pnp_pose_network if kind == "network" else JaxVolume.bootstrap
            cache[(kind, name)] = fn(ip, cams)
        return cache[(kind, name)]

    return get


@pytest.fixture(scope="module")
def poses(scenes):
    return {
        name: (JP.estimate_camera_object_poses(ip, cams), TP.estimate_camera_object_poses(pip, pcams, device="cpu"))
        for name, (ip, cams, pip, pcams) in scenes.items()
        if name != "partial"
    }


@pytest.fixture
def jax_samples(monkeypatch):
    """The port's RANSACs draw the JAX package's samples."""
    monkeypatch.setattr(TE, "sample_indices", jax_sample_indices)


@pytest.mark.parametrize("name", ["ring", "sparse"])
def test_estimate_camera_object_poses_matches_jax(poses, name):
    jp, tp = poses[name]
    for col in ("sync_index", "cam_id", "object_id", "n_points"):
        np.testing.assert_array_equal(getattr(tp, col), getattr(jp, col))
    np.testing.assert_allclose(TL.so3_exp_host(tp.rvec), TL.so3_exp_host(jp.rvec), atol=RESECTION_TOL)
    np.testing.assert_allclose(tp.tvec, jp.tvec, atol=RESECTION_TOL)
    np.testing.assert_allclose(tp.rms, jp.rms, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["ring", "sparse"])
def test_relative_samples_rejection_and_aggregation_match_jax(poses, name):
    """On the same resections (the JAX package's), the host algebra is the
    JAX package's numpy path: samples, IQR keep sets and averaged pairs."""
    jp, _ = poses[name]
    js, ts = JP.relative_pose_samples(jp), TP.relative_pose_samples(TP.CameraObjectPoses(**vars(jp)))
    assert list(ts) == list(js)
    ji, ti = JP.reject_outliers(js), TP.reject_outliers(ts)
    for key in js:
        for field in ("R", "t", "rms"):
            np.testing.assert_allclose(ts[key][field], js[key][field], atol=HOST_TOL)
            np.testing.assert_allclose(ti[key][field], ji[key][field], atol=HOST_TOL)
    ja, ta = JP.aggregate_pairs(ji), TP.aggregate_pairs(ti)
    for key, jsp in ja.items():
        tsp = ta[key]
        assert tsp.pair == jsp.pair and tsp.error_score == pytest.approx(jsp.error_score, rel=HOST_TOL)
        np.testing.assert_allclose(tsp.rotation, jsp.rotation, atol=HOST_TOL)
        np.testing.assert_allclose(tsp.translation, jsp.translation, atol=HOST_TOL)


@pytest.mark.parametrize("name", ["ring", "sparse"])
def test_stereo_rmse_matches_jax(scenes, poses, name):
    ip, cams, pip, pcams = scenes[name]
    jp, _ = poses[name]
    pairs = JP.aggregate_pairs(JP.reject_outliers(JP.relative_pose_samples(jp)))
    port_pairs = convert.stereo_pairs(network_pairs(JP.PairedPoseNetwork(pairs)))
    batch = TP.stereo_rmse_batch([port_pairs[key] for key in pairs], pip, pcams, device="cpu")
    for key in pairs:
        want = JP.stereo_rmse(pairs[key], ip, cams)
        got = TP.stereo_rmse(port_pairs[key], pip, pcams, device="cpu")
        assert got == pytest.approx(want, rel=GEOM_TOL)
        assert batch[key] == pytest.approx(want, rel=GEOM_TOL)
        assert 0.0 < got < 5.0


def test_network_bridging_and_apply_to_match_jax(scenes, poses):
    """Raw pairs with two links cut, so that bridging must fill them, then
    the anchor search and the rig it poses."""
    ip, cams, pip, pcams = scenes["ring"]
    jp, _ = poses["ring"]
    raw = JP.aggregate_pairs(JP.reject_outliers(JP.relative_pose_samples(jp)), ip, cams)
    for cut in ((0, 2), (1, 3)):
        del raw[cut]
    jnet = JP.PairedPoseNetwork.from_raw_estimates(raw)
    tnet = TP.PairedPoseNetwork.from_raw_estimates(convert.stereo_pairs(network_pairs(JP.PairedPoseNetwork(raw))))
    assert list(tnet.pairs) == list(jnet.pairs)
    assert len(jnet.pairs) == 12  # every ordered pair, the cut ones bridged
    for key, jsp in jnet.pairs.items():
        tsp = tnet.pairs[key]
        assert tsp.error_score == pytest.approx(jsp.error_score, rel=HOST_TOL)
        np.testing.assert_allclose(tsp.rotation, jsp.rotation, atol=HOST_TOL)
        np.testing.assert_allclose(tsp.translation, jsp.translation, atol=HOST_TOL)
    jc, tc = cams.copy(), pcams.copy()
    assert tnet.apply_to(tc) == jnet.apply_to(jc)
    assert_same_rig(tc, jc, HOST_TOL)
    assert tnet.connected_components(sorted(tc.cameras)) == jnet.connected_components(sorted(jc.cameras))


def test_pose_network_carrier_and_toml_round_trip(jax_runs, tmp_path):
    """convert.pose_network carries a JAX network across; each package
    writes the same stereo_pairs.toml bytes and reads the other's."""
    jnet = jax_runs("network", "ring")
    tnet = convert.pose_network(network_pairs(jnet))
    assert list(tnet.pairs) == list(jnet.pairs)
    jnet.to_toml(tmp_path / "jax.toml")
    tnet.to_toml(tmp_path / "port.toml")
    assert (tmp_path / "port.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()
    back = TP.PairedPoseNetwork.from_toml(tmp_path / "jax.toml")
    jback = JP.PairedPoseNetwork.from_toml(tmp_path / "port.toml")
    for key, jsp in jback.pairs.items():
        np.testing.assert_allclose(back.pairs[key].rotation, jsp.rotation, atol=HOST_TOL)
        np.testing.assert_allclose(back.pairs[key].translation, jsp.translation, atol=HOST_TOL)
    with pytest.raises(ValueError, match="fields"):
        convert.stereo_pairs({(0, 1): {"primary_cam_id": 0}})


@pytest.mark.parametrize("name", ["ring", "sparse"])
def test_build_pnp_pose_network_matches_jax(scenes, jax_runs, name):
    ip, cams, pip, pcams = scenes[name]
    jnet = jax_runs("network", name)
    tnet = TP.build_pnp_pose_network(pip, pcams, device="cpu")
    assert list(tnet.pairs) == list(jnet.pairs)
    for key, jsp in jnet.pairs.items():
        tsp = tnet.pairs[key]
        assert tsp.error_score == pytest.approx(jsp.error_score, rel=1e-7)
        np.testing.assert_allclose(tsp.rotation, jsp.rotation, atol=RESECTION_TOL)
        np.testing.assert_allclose(tsp.translation, jsp.translation, atol=RESECTION_TOL)


def rig_offset(port_rig, jax_rig):
    """Largest rotation (deg) and center (m) gap between two rigs after a
    similarity moves the port's camera centers onto the JAX package's."""
    from caliscope_tpu_torch.ops.similarity import SimilarityParams, umeyama

    ids = sorted(jax_rig.posed_cameras)
    center = lambda c: -c.rotation.T @ c.translation  # noqa: E731
    src = np.array([center(port_rig.cameras[c]) for c in ids])
    dst = np.array([center(jax_rig.cameras[c]) for c in ids])
    s_, R, t_ = umeyama(src, dst)
    sim = SimilarityParams(float(s_), R.numpy(), t_.numpy())
    rot = [
        np.degrees(TL.rotation_geodesic_angle_host(port_rig.cameras[c].rotation @ sim.rotation.T, jax_rig.cameras[c].rotation))
        for c in ids
    ]
    return max(rot), float(np.abs(sim.apply(src) - dst).max())


def test_scaffold_assembly_matches_jax_on_its_samples(scenes, jax_runs, jax_samples):
    """The same network (carried across) re-assembled from its best pairs,
    the port's RANSACs on the JAX package's samples: the same rig."""
    ip, cams, pip, pcams = scenes["ring"]
    jnet = jax_runs("network", "ring")
    jrig = JP.scaffold_assembly(ip, cams, jnet, max_candidates=3)
    trig = TP.scaffold_assembly(pip, pcams, convert.pose_network(network_pairs(jnet)), max_candidates=3, device="cpu")
    assert len(trig.posed_cameras) == len(jrig.posed_cameras) == 4
    assert_same_rig(trig, jrig, GEOM_TOL)


def test_scaffold_assembly_on_its_own_samples(scenes, jax_runs):
    """The port's own samples: points near the 3 px gate can fall either
    side of another hypothesis, which moves the medians the candidates are
    ranked by, so another pair may seed the rig (another gauge), and a rig
    seeded by one pair before any BA differs from another's by a few
    tenths of a degree (0.17 seen). Held to the pipeline's own 0.5 deg / 5 mm
    after a similarity."""
    ip, cams, pip, pcams = scenes["ring"]
    jnet = jax_runs("network", "ring")
    jrig = JP.scaffold_assembly(ip, cams, jnet, max_candidates=3)
    trig = TP.scaffold_assembly(pip, pcams, convert.pose_network(network_pairs(jnet)), max_candidates=3, device="cpu")
    assert sorted(trig.posed_cameras) == [0, 1, 2, 3]
    rot_deg, center_m = rig_offset(trig, jrig)
    assert rot_deg < 0.5 and center_m < 5e-3


def test_bootstrap_matches_jax_on_the_ring(scenes, jax_runs):
    ip, cams, pip, pcams = scenes["ring"]
    jv = jax_runs("bootstrap", "ring")
    tv = PortVolume.bootstrap(pip, pcams, device="cpu")
    assert tv.device.type == "cpu" and tv.dtype == torch.float64
    assert_same_rig(tv.camera_array, jv.camera_array, GEOM_TOL)
    np.testing.assert_array_equal(tv.world_points.keys(), jv.world_points.keys())
    np.testing.assert_allclose(tv.world_points.xyz, jv.world_points.xyz, atol=1e-8)
    assert tv.reprojection_report.overall_rmse == pytest.approx(jv.reprojection_report.overall_rmse, rel=GEOM_TOL)


def test_bootstrap_on_chained_coverage_matches_jax(scenes, jax_runs):
    """Six culled cameras in a chain. Two anchors of this symmetric ring tie
    in total error to ~1e-9, so the two packages may anchor the rig on
    different cameras; what the rig explains must agree."""
    ip, cams, pip, pcams = scenes["sparse"]
    jv = jax_runs("bootstrap", "sparse")
    tv = PortVolume.bootstrap(pip, pcams, device="cpu")
    assert sorted(tv.camera_array.posed_cameras) == sorted(jv.camera_array.posed_cameras) == list(range(6))
    np.testing.assert_array_equal(tv.world_points.keys(), jv.world_points.keys())
    assert tv.reprojection_report.overall_rmse == pytest.approx(jv.reprojection_report.overall_rmse, rel=1e-6)
    assert tv.reprojection_report.overall_rmse < 1.0


@pytest.mark.parametrize("samples", ["jax", "port"])
def test_bootstrap_repairs_a_camera_the_network_cannot_place(scenes, jax_runs, samples, monkeypatch):
    """Camera 3 sees 3 corners a frame: no resection, so no pairs; the
    repair resects it against the other cameras' cloud (PnP-RANSAC). On the
    JAX package's samples the rig is the JAX package's; on the port's own,
    camera 3 (resected from 60 rows bunched in one corner of the board)
    lands within the noise of it."""
    if samples == "jax":
        monkeypatch.setattr(TE, "sample_indices", jax_sample_indices)
    ip, cams, pip, pcams = scenes["partial"]
    assert TP.build_pnp_pose_network(pip, pcams, device="cpu").get_pair(0, 3) is None
    jv = jax_runs("bootstrap", "partial")
    tv = PortVolume.bootstrap(pip, pcams, device="cpu")
    assert sorted(tv.camera_array.posed_cameras) == [0, 1, 2, 3]
    if samples == "jax":
        assert_same_rig(tv.camera_array, jv.camera_array, GEOM_TOL)
        assert tv.reprojection_report.overall_rmse == pytest.approx(jv.reprojection_report.overall_rmse, rel=GEOM_TOL)
    else:
        rot_deg, center_m = rig_offset(tv.camera_array, jv.camera_array)
        assert rot_deg < 0.5 and center_m < 5e-3
        assert tv.reprojection_report.by_camera[3] < 1.0


def test_repair_re_resects_a_mis_posed_camera(scenes, jax_runs, jax_samples):
    """A bootstrapped ring with camera 2 turned by 10 degrees: both packages'
    repair passes put it back, to the same pose."""
    ip, cams, pip, pcams = scenes["ring"]
    jv = jax_runs("bootstrap", "ring")
    bad = jv.camera_array.copy()
    bad.cameras[2].rotation = JL.so3_exp(np.array([0.0, 0.1745, 0.0])) @ bad.cameras[2].rotation
    jbad = JaxVolume(bad, ip, jv.world_points)
    tbad = PortVolume(port_cameras(bad), pip, port_world(jv.world_points), device="cpu")
    assert tbad.reprojection_report.by_camera[2] > 40.0
    jfix = jax_repair(jbad, frozenset())
    tfix = port_repair(tbad, frozenset())
    assert_same_rig(tfix.camera_array, jfix.camera_array, GEOM_TOL)
    assert tfix.reprojection_report.by_camera[2] < 1.0


def test_markerless_bootstrap_is_not_ported(scenes, monkeypatch):
    """Markerless input is ported now: build_pose_network and the bootstrap
    hand it to the epipolar bootstrap (held against the JAX package in
    tests/test_torch_epipolar_bootstrap.py)."""
    import caliscope_tpu_torch.solvers.epipolar as PE

    _, _, pip, pcams = scenes["ring"]
    bare = convert.image_points({f: getattr(pip, f) for f in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy")})
    seen = []

    def reached(ip, cams, device=None):
        seen.append(device)
        raise LookupError("epipolar bootstrap reached")

    monkeypatch.setattr(PE, "build_epipolar_pose_network", reached)
    with pytest.raises(LookupError, match="epipolar bootstrap reached"):
        TP.build_pose_network(bare, pcams, device="cpu")
    with pytest.raises(LookupError, match="epipolar bootstrap reached"):
        PortVolume.bootstrap(bare, pcams, device="cpu")
    assert [str(d) for d in seen] == ["cpu", "cpu"]


def test_quaternion_and_rotation_host_twins_match_jax(rng):
    """The graph algebra's numpy twins, and their torch forms, against the
    JAX package's lie functions (numpy path and jnp path). The quaternion
    and angle twins run the torch forms on float64 CPU tensors, so they
    agree with the JAX package's numpy path to roundoff (1e-14; seen:
    4.4e-16 on the angle, 1.1e-16 on the average), not bit for bit."""
    import jax.numpy as jnp

    rv = np.concatenate([rng.normal(size=(10, 3)), [[0.0, 0.0, 0.0], [np.pi - 1e-6, 0.0, 0.0]]])
    R = TL.so3_exp_host(rv)
    q = TL.quat_from_matrix_host(R)
    np.testing.assert_array_equal(q, JL.quat_from_matrix(R))
    np.testing.assert_array_equal(TL.matrix_from_quat_host(q), JL.matrix_from_quat(q))
    np.testing.assert_allclose(TL.rotation_geodesic_angle_host(R[:6], R[6:]), JL.rotation_geodesic_angle(R[:6], R[6:]), atol=1e-14)
    w = rng.uniform(0.5, 1.0, size=len(q))
    np.testing.assert_allclose(TL.quaternion_average_host(q, w), JL.quaternion_average(q, w), atol=1e-14)
    Rt, tt = TL.se3_inverse_host(R, rv)
    Rj, tj = JL.se3_inverse(R, rv)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    np.testing.assert_allclose(TL.matrix_from_quat(T(q)).numpy(), np.asarray(JL.matrix_from_quat(jnp.asarray(q))), atol=1e-14)
    np.testing.assert_allclose(
        TL.rotation_geodesic_angle(T(R[:6]), T(R[6:])).numpy(), np.asarray(JL.rotation_geodesic_angle(jnp.asarray(R[:6]), jnp.asarray(R[6:]))), atol=1e-12
    )
    np.testing.assert_allclose(TL.quaternion_average(T(q), T(w)).numpy(), np.asarray(JL.quaternion_average(jnp.asarray(q), jnp.asarray(w))), atol=1e-12)
