"""The port's markerless (epipolar) bootstrap (caliscope_tpu_torch/solvers/
epipolar.py) held against the JAX package's, step by step and as the
pipeline runs it.

Scene: the JAX suite's markerless ring, default_ring_scene(noise_sigma_px=
0.5, n_frames=25) with obj_loc stripped and extrinsics stripped
(tests/synthetic/test_epipolar_bootstrap.py), carried across as numpy. JAX
runs in x64, the port in float64 on the CPU. On the JAX package's own
RANSAC samples (the `jax_samples` fixture) the two agree to float64
roundoff: pair poses and resections within 1e-9 with identical inlier sets,
the pose network within 1e-8 (three host steps of algebra on top), and the
calibrated rig within 1e-6 (three LM solves amplify roundoff, as in
tests/test_torch_pipeline.py). The port's own sampler is held to the JAX
suite's bounds against the truth: 2 cm before BA, 1 cm after.
"""

from __future__ import annotations

import numpy as np
import pytest

import caliscope_tpu.solvers.epipolar as JE
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.pipelines import calibrate_extrinsics as jax_calibrate
from caliscope_tpu.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu.synthetic.factories import default_ring_scene

import caliscope_tpu_torch.ops.epipolar as TE
import caliscope_tpu_torch.solvers.epipolar as PE
import caliscope_tpu_torch.solvers.pose_network as TP
from caliscope_tpu_torch.ops.similarity import umeyama
from caliscope_tpu_torch.pipelines import calibrate_extrinsics
from caliscope_tpu_torch.volume import CaptureVolume as PortVolume
from torch_pose_common import jax_sample_indices, one_torch_thread, port_cameras, port_points  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POSE_TOL = 1e-9
NETWORK_TOL = 1e-8
RIG_TOL = 1e-6


def strip_obj_loc(ip):
    return JaxImagePoints(
        ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id, ip.img_xy,
        np.full((len(ip), 3), np.nan), ip.frame_time,
    )


@pytest.fixture(scope="module")
def scene():
    """(scene, JAX points, JAX unposed cameras, port points, port cameras)."""
    sc = default_ring_scene(noise_sigma_px=0.5, n_frames=25)
    ip, cams = strip_obj_loc(sc.image_points_noisy()), strip_extrinsics(sc.cameras)
    return sc, ip, cams, port_points(ip), port_cameras(cams)


@pytest.fixture
def jax_samples(monkeypatch):
    """The port's RANSACs draw the JAX package's samples."""
    monkeypatch.setattr(TE, "sample_indices", jax_sample_indices)


@pytest.fixture(scope="module")
def jax_runs(scene, tmp_path_factory):
    """The JAX package's pose network and markerless pipeline on the scene,
    each computed once per test run."""
    from tests.fixture_cache import per_run_cached

    _, ip, cams, _, _ = scene

    def compute():
        from torch_pose_common import network_pairs

        network = network_pairs(JE.build_epipolar_pose_network(ip, cams))
        run = jax_calibrate(ip, cams, None)
        vol = run.capture_volume
        rig = {cid: (c.rotation, c.translation) for cid, c in vol.camera_array.posed_cameras.items()}
        return network, rig, len(vol.image_points)

    return per_run_cached(tmp_path_factory, "torch_epipolar_markerless", compute)


def aligned_center_errors(scene_, cameras):
    """Camera centers against the truth after a similarity with scale."""
    gt = {cid: -c.rotation.T @ c.translation for cid, c in scene_.cameras.cameras.items()}
    est = {cid: -c.rotation.T @ c.translation for cid, c in cameras.posed_cameras.items()}
    ids = sorted(set(gt) & set(est))
    src, dst = np.array([est[c] for c in ids]), np.array([gt[c] for c in ids])
    s, R, t = umeyama(src, dst)
    aligned = float(s) * (R.numpy() @ src.T).T + t.numpy()
    return np.linalg.norm(aligned - dst, axis=1)


def duplicate_key_table():
    """Two cameras with repeated keys (a dict keeps the last), a static
    sync index, keys only one camera has, and rows out of key order."""
    rng = np.random.default_rng(3)
    sync = np.array([-1, 0, 0, 2, 1, 5, 0, 2, 2, -1, 1, 7, 0, 0])
    cam = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 0])
    obj = np.array([0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0])
    kp = np.array([3, 1, 1, 2, 4, 0, 1, 2, 2, 3, 4, 9, 1, 1])
    return JaxImagePoints(sync, cam, obj, kp, rng.uniform(0, 1000, (len(sync), 2)))


def test_pooled_correspondences_match_jax(scene):
    """Keys, their order (camera b's rows) and pixels identical, on every
    pair of the ring and on a table with duplicate and static keys."""
    _, ip, _, pip, _ = scene
    dup = duplicate_key_table()
    cases = [(ip, pip, a, b) for a in range(4) for b in range(a + 1, 4)]
    cases += [(dup, port_points(dup), 0, 1), (dup, port_points(dup), 1, 0)]
    for jip, tip, a, b in cases:
        want = JE.pooled_correspondences(jip, a, b)
        got = PE.pooled_correspondences(tip, a, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(PE.pooled_correspondences(port_points(dup), 0, 1)[0]) == 6


def test_pair_pose_cloud_and_resection_match_jax(scene, jax_samples):
    """recover_pair_pose on one pair, the scaffold cloud from the JAX
    package's pose, and a third camera's resection against that cloud."""
    _, ip, cams, pip, pcams = scene
    keys, pa, pb = JE.pooled_correspondences(ip, 0, 1)
    want = JE.recover_pair_pose(pa, pb, camera_a=cams.cameras[0], camera_b=cams.cameras[1], seed=1)
    got = PE.recover_pair_pose(pa, pb, camera_a=pcams.cameras[0], camera_b=pcams.cameras[1], seed=1, device="cpu")
    np.testing.assert_allclose(got["rotation"], want["rotation"], atol=POSE_TOL)
    np.testing.assert_allclose(got["translation"], want["translation"], atol=POSE_TOL)
    np.testing.assert_array_equal(got["inlier_index"], want["inlier_index"])
    for field in ("n_inliers", "n_total", "cheirality_inliers"):
        assert got[field] == want[field], field
    assert got["conditioning"] == pytest.approx(want["conditioning"], abs=POSE_TOL)

    jcloud = JE.triangulate_scaffold(want, keys)
    cloud = PE.triangulate_scaffold(want, keys, device="cpu")
    assert [tuple(k) for k in cloud.keys.tolist()] == list(jcloud)
    np.testing.assert_allclose(cloud.xyz, np.array(list(jcloud.values())), atol=POSE_TOL)
    for cid in (2, 3):
        jR, jt, jn, jmed = JE.resection_camera(jcloud, ip, cid, cams.cameras[cid])
        R, t, n, med = PE.resection_camera(cloud, pip, cid, pcams.cameras[cid], device="cpu")
        assert n == jn
        np.testing.assert_allclose(R, jR, atol=POSE_TOL)
        np.testing.assert_allclose(t, jt, atol=POSE_TOL)
        assert med == pytest.approx(jmed, rel=1e-7)


def test_resection_refuses_a_small_or_empty_cloud(scene):
    _, _, _, pip, pcams = scene
    empty = PE.ScaffoldCloud(np.zeros((0, 3), np.int64), np.zeros((0, 3)))
    with pytest.raises(ValueError, match="empty"):
        PE.resection_camera(empty, pip, 2, pcams.cameras[2], device="cpu")
    tiny = PE.ScaffoldCloud(PE._keys(pip, np.flatnonzero(pip.cam_id == 2)[:10]), np.ones((10, 3)))
    with pytest.raises(ValueError, match="only 10 cloud points"):
        PE.resection_camera(tiny, pip, 2, pcams.cameras[2], device="cpu")


def test_build_epipolar_pose_network_matches_jax(scene, jax_runs, jax_samples):
    """The same scaffold and anchor (the same anchor-relative pairs), pair
    poses within 1e-8, stereo scores within 1e-8 relative."""
    _, _, _, pip, pcams = scene
    want, _, _ = jax_runs
    got = PE.build_epipolar_pose_network(pip, pcams, device="cpu").pairs
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        np.testing.assert_allclose(g.rotation, w["rotation"], atol=NETWORK_TOL)
        np.testing.assert_allclose(g.translation, w["translation"], atol=NETWORK_TOL)
        assert g.error_score == pytest.approx(w["error_score"], rel=NETWORK_TOL)


def test_markerless_pipeline_matches_jax(scene, jax_runs, jax_samples):
    """calibrate_extrinsics on markerless data: the same kept observations
    and the rig within 1e-6 of the JAX run."""
    _, _, _, pip, pcams = scene
    _, rig, n_kept = jax_runs
    vol = calibrate_extrinsics(pip, pcams, None, device="cpu").capture_volume
    assert len(vol.image_points) == n_kept
    assert sorted(vol.camera_array.posed_cameras) == sorted(rig)
    for cid, (R, t) in rig.items():
        c = vol.camera_array.cameras[cid]
        np.testing.assert_allclose(c.rotation, R, atol=RIG_TOL)
        np.testing.assert_allclose(c.translation, t, atol=RIG_TOL)


def test_port_sampler_recovers_the_rig_up_to_similarity(scene):
    """On the port's own samples: every camera posed, centers within 2 cm
    of the truth after a similarity, and within 1 cm after BA, with a lower
    RMSE (the JAX suite's bounds)."""
    sc, _, _, pip, pcams = scene
    volume = PortVolume.bootstrap(pip, pcams, device="cpu")
    assert len(volume.camera_array.posed_cameras) == len(sc.cameras.cameras)
    assert aligned_center_errors(sc, volume.camera_array).max() < 0.02
    optimized = volume.optimize()
    assert optimized.reprojection_report.overall_rmse < volume.reprojection_report.overall_rmse
    assert aligned_center_errors(sc, optimized.camera_array).max() < 0.01


def test_dispatch_sends_markerless_input_to_the_epipolar_bootstrap(scene, monkeypatch):
    """build_pose_network reaches build_epipolar_pose_network when no row
    has obj_loc, with the caller's device."""
    _, _, _, pip, pcams = scene
    seen = []
    monkeypatch.setattr(PE, "build_epipolar_pose_network", lambda ip, cams, device=None: seen.append(device) or "net")
    assert TP.build_pose_network(pip, pcams, device="cpu") == "net"
    assert seen == ["cpu"]


@pytest.mark.cuda
def test_markerless_pipeline_on_the_card_matches_the_cpu(scene, monkeypatch):
    """The markerless pipeline on the card (float32) against the port's CPU
    run (float64), both drawing their RANSAC samples from the CPU generator
    so that they draw the same ones: within 0.05 deg / 1 mm after each is
    moved onto the truth by a similarity."""
    import torch

    from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host
    from caliscope_tpu_torch.ops.similarity import SimilarityParams

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    draw = TE.sample_indices
    monkeypatch.setattr(TE, "sample_indices", lambda mask, n, k, seed: draw(mask.cpu(), n, k, seed).to(mask.device))
    sc, _, _, pip, pcams = scene
    aligned = {}
    for dev in ("cuda", "cpu"):
        vol = calibrate_extrinsics(pip, pcams, None, device=dev).capture_volume
        center = lambda c: -c.rotation.T @ c.translation  # noqa: E731
        ids = sorted(vol.camera_array.posed_cameras)
        assert ids == sorted(sc.cameras.cameras)
        s, R, t = umeyama(np.array([center(vol.camera_array.cameras[c]) for c in ids]),
                          np.array([center(sc.cameras.cameras[c]) for c in ids]))
        aligned[dev] = vol._apply_similarity(SimilarityParams(float(s), R.numpy(), t.numpy())).camera_array
    for cid, g in aligned["cuda"].cameras.items():
        c = aligned["cpu"].cameras[cid]
        assert np.degrees(rotation_geodesic_angle_host(g.rotation, c.rotation)) <= 0.05
        assert np.linalg.norm(g.rotation.T @ g.translation - c.rotation.T @ c.translation) <= 0.001
