"""The port's extrinsic calibration pipeline
(caliscope_tpu_torch.pipelines.calibrate_extrinsics) held against the JAX
package's on the same inputs, and against the truth.

default_ring_scene(4, 20) (the JAX package's engine, carried across as
numpy) from cameras with intrinsics and no extrinsics; the JAX package runs
once, in x64, in a module fixture (its first run compiles for tens of
seconds), the port in float64 on the CPU. Both must agree on the
depth-ratio gate, the kept observations, the intrinsic estimates and every
camera's pose (rotation within 1e-6 rad as matrices, centers within 1e-6
m: float64 roundoff amplified by three LM solves and a bootstrap is ~1e-14
here), and both must meet the JAX package's own headline contract, 0.5 deg
/ 5 mm per camera against the truth after Umeyama on the camera centers
(tests/synthetic/test_production_pipeline.py). Anchoring and the
similarity ops are held to 1e-12 on the same volume state.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.ops.similarity as JSim
from caliscope_tpu.pipelines import calibrate_extrinsics as jax_calibrate
from caliscope_tpu.pipelines.calibrate_extrinsics import _cameras_with_placeholder_intrinsics as jax_placeholders
from caliscope_tpu.synthetic.camera_synthesizer import strip_extrinsics, strip_intrinsics
from caliscope_tpu.synthetic.factories import default_ring_scene
from caliscope_tpu.volume import CaptureVolume as JaxVolume

import caliscope_tpu_torch.ops.similarity as TSim
from caliscope_tpu_torch import convert
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host
from caliscope_tpu_torch.pipelines import calibrate_extrinsics, refresh_run
from caliscope_tpu_torch.pipelines.calibrate_extrinsics import _cameras_with_placeholder_intrinsics
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics as port_strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import sparse_coverage_scene as port_sparse_coverage_scene
from caliscope_tpu_torch.tasks import CancellationToken
from caliscope_tpu_torch.volume import CaptureVolume as PortVolume
from torch_pose_common import port_cameras, port_points, port_world

POSE_TOL = 1e-6
ROTATION_TOL_DEG = 0.5
TRANSLATION_TOL_M = 0.005
CARD_VS_CPU_ROTATION_DEG = 0.05
CARD_VS_CPU_CENTER_M = 0.001


def center(cam):
    return -cam.rotation.T @ cam.translation


@pytest.fixture(scope="module")
def runs():
    """(scene, JAX inputs, port inputs, JAX run, JAX progress, port run,
    port progress)."""
    scene = default_ring_scene(4, 20)
    ip, cams = scene.image_points_noisy(), strip_extrinsics(scene.cameras)
    pip, pcams = port_points(ip), port_cameras(cams)
    jprog, tprog = [], []
    jrun = jax_calibrate(ip, cams, None, progress=lambda p, s: jprog.append((p, s)))
    trun = calibrate_extrinsics(pip, pcams, None, progress=lambda p, s: tprog.append((p, s)), device="cpu")
    return scene, (ip, cams), (pip, pcams), jrun, jprog, trun, tprog


def aligned_to_truth(cameras, truth):
    """Per camera (rotation, center) after Umeyama (with scale) of the
    camera centers onto the truth's (the JAX package's headline check)."""
    ids = sorted(cameras.posed_cameras)
    src = np.array([center(cameras.cameras[c]) for c in ids])
    s, R, t = TSim.umeyama(src, np.array([center(truth.cameras[c]) for c in ids]))
    sim = TSim.SimilarityParams(float(s), R.numpy(), t.numpy())
    return {c: (cameras.cameras[c].rotation @ sim.rotation.T, moved) for c, moved in zip(ids, sim.apply(src))}


def gaps(a, b):
    """Per camera (rotation gap deg, center gap m) between two aligned rigs."""
    return {
        c: (float(np.degrees(rotation_geodesic_angle_host(a[c][0], b[c][0]))), float(np.linalg.norm(a[c][1] - b[c][1])))
        for c in b
    }


def errors_to_truth(cameras, truth):
    return gaps(aligned_to_truth(cameras, truth), {c: (cam.rotation, center(cam)) for c, cam in truth.cameras.items()})


def test_pipeline_matches_jax(runs):
    _scene, _j, _p, jrun, _jp, trun, _tp = runs
    jv, tv = jrun.capture_volume, trun.capture_volume
    assert tv.device.type == "cpu" and tv.dtype == torch.float64
    assert trun.intrinsic_refinement_gated == jrun.intrinsic_refinement_gated
    assert trun.synthesized_cam_ids == jrun.synthesized_cam_ids == frozenset()
    assert trun.dropped_static_markers == jrun.dropped_static_markers == ()
    assert len(tv.image_points) == len(jv.image_points)
    for col in ("sync_index", "cam_id", "object_id", "keypoint_id"):
        np.testing.assert_array_equal(getattr(tv.image_points, col), getattr(jv.image_points, col))
    for cid, jc in jv.camera_array.cameras.items():
        tc = tv.camera_array.cameras[cid]
        assert rotation_geodesic_angle_host(tc.rotation, jc.rotation) < POSE_TOL
        assert np.linalg.norm(center(tc) - center(jc)) < POSE_TOL
        np.testing.assert_allclose(tc.matrix, jc.matrix, rtol=1e-9)
    assert len(trun.intrinsic_estimates) == len(jrun.intrinsic_estimates) == 4
    for te, je in zip(trun.intrinsic_estimates, jrun.intrinsic_estimates):
        assert te.cam_id == je.cam_id
        assert te.f_recovered == pytest.approx(je.f_recovered, rel=1e-9)
        assert te.f_change_pct == pytest.approx(je.f_change_pct, abs=1e-7)
    assert tv.optimization_status.iterations == jv.optimization_status.iterations
    assert tv.reprojection_report.overall_rmse == pytest.approx(jv.reprojection_report.overall_rmse, rel=1e-7)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_pipeline_meets_the_headline_contract(runs, which):
    scene, _j, _p, jrun, _jp, trun, _tp = runs
    run = jrun if which == "jax" else trun
    errs = errors_to_truth(port_cameras(run.capture_volume.camera_array), port_cameras(scene.cameras))
    assert len(errs) == 4 and len(run.capture_volume.camera_array.posed_cameras) == 4
    assert max(e[0] for e in errs.values()) <= ROTATION_TOL_DEG, errs
    assert max(e[1] for e in errs.values()) <= TRANSLATION_TOL_M, errs


def test_progress_matches_jax(runs):
    _scene, _j, _p, _jr, jprog, _tr, tprog = runs
    assert tprog == jprog
    assert tprog[-1] == (100, "Optimization complete")


def test_refresh_run_recomputes_estimates_against_the_anchors(runs):
    _scene, _j, _p, _jr, _jp, trun, _tp = runs
    again = refresh_run(trun, trun.capture_volume)
    assert again.intrinsic_estimates == trun.intrinsic_estimates
    assert again.intrinsic_refinement_gated == trun.intrinsic_refinement_gated
    assert again.capture_volume is trun.capture_volume


def test_cancellation_between_stages(runs):
    _scene, _j, (pip, pcams), *_ = runs
    token = CancellationToken()
    token.cancel()
    seen = []
    with pytest.raises(InterruptedError):
        calibrate_extrinsics(pip, pcams, None, cancellation_token=token, progress=lambda p, s: seen.append(p), device="cpu")
    assert seen == []
    token = CancellationToken()

    def cancel_at_linear_ba(pct, label):
        seen.append(label)
        if label == "Optimizing":
            token.cancel()

    with pytest.raises(InterruptedError, match="cancelled"):
        calibrate_extrinsics(pip, pcams, None, cancellation_token=token, progress=cancel_at_linear_ba, device="cpu")
    assert seen == ["Preparing cameras", "Bootstrapping poses", "Reviewing static markers", "Optimizing"]
    with pytest.raises(InterruptedError, match="stop"):
        token.raise_if_cancelled("stop")


def test_constraints_and_markerless_input_are_not_ported(runs):
    """Constraints are ported: the board truss runs every stage and holds
    the board to the JAX package's 2 mm rigidity limit. Markerless input
    (the epipolar bootstrap, item 22) still raises."""
    scene, _j, (pip, pcams), *_ = runs
    from caliscope_tpu_torch.constraints import ConstraintSet

    truss = ConstraintSet(ConstraintSet._truss_constraints(scene.objects[0].points_local, 0.054, 0.002), frozenset())
    seen = []
    run = calibrate_extrinsics(pip, pcams, truss, progress=lambda p, s: seen.append(p), device="cpu")
    assert seen == [5, 15, 25, 40, 50, 55, 75, 90, 100]
    assert run.capture_volume.constraints == truss
    assert 0 < run.capture_volume.rigidity_report().rmse_mm < 2.0
    bare = convert.image_points({f: getattr(pip, f) for f in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy")})
    with pytest.raises(NotImplementedError, match="item 22"):
        calibrate_extrinsics(bare, pcams, None, device="cpu")
    # placeholder intrinsics on markerless data: the guard refuses first, as in the JAX package
    blind = port_cameras(strip_intrinsics(strip_extrinsics(default_ring_scene(4, 2).cameras)))
    with pytest.raises(CalibrationError, match="placeholder intrinsics"):
        calibrate_extrinsics(bare, blind, None, device="cpu")


def test_pipeline_on_a_sparse_layout_is_not_ported(monkeypatch):
    """sparse_coverage_scene (6 cameras, culled, chained co-visibility):
    its (P, C) grid is under a third full, so every BA stage runs the
    sparse row layout. With the board truss (the production configuration:
    unconstrained, the chain's near-flat deformation manifold lets the
    cameras drift by meters at sub-pixel cost, as the JAX package's
    tests/synthetic/test_topologies.py records) it calibrates end to end
    and meets 0.5 deg / 5 mm against the truth."""
    from caliscope_tpu_torch.constraints import ConstraintSet
    from caliscope_tpu_torch.solvers import bundle as TB

    scene = port_sparse_coverage_scene()
    truss = ConstraintSet(ConstraintSet._truss_constraints(scene.objects[0].points_local, 0.06, 0.002), frozenset())
    problems = []
    make_problem = TB.make_problem
    monkeypatch.setattr(TB, "make_problem", lambda *a, **k: problems.append(1) or make_problem(*a, **k))
    seen = []
    run = calibrate_extrinsics(
        scene.image_points_noisy(), port_strip_extrinsics(scene.cameras), truss, refine_intrinsics=False,
        progress=lambda p, s: seen.append(s), device="cpu",
    )
    assert seen[-1] == "Optimization complete" and len(problems) == 3
    cameras = run.capture_volume.camera_array
    assert len(cameras.posed_cameras) == len(scene.cameras.cameras)
    for rot_deg, center_m in errors_to_truth(cameras, scene.cameras).values():
        assert rot_deg <= ROTATION_TOL_DEG and center_m <= TRANSLATION_TOL_M


def test_placeholder_intrinsics_match_jax():
    cams = strip_intrinsics(strip_extrinsics(default_ring_scene(4, 2).cameras))
    cams.cameras[2] = default_ring_scene(4, 2).cameras.cameras[2]
    jblind, tblind = set(), set()
    jw = jax_placeholders(cams, jblind)
    tw = _cameras_with_placeholder_intrinsics(port_cameras(cams), tblind)
    assert tblind == jblind == {0, 1, 3}
    for cid, jc in jw.cameras.items():
        np.testing.assert_array_equal(tw.cameras[cid].matrix, jc.matrix)
        np.testing.assert_array_equal(tw.cameras[cid].distortions, jc.distortions)


def test_default_device_is_cuda(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    _scene, _j, (pip, pcams), *_ = runs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_extrinsics(pip, pcams, None)


@pytest.fixture(scope="module")
def volumes(runs):
    """The JAX run's final volume, and the same state in the port."""
    _scene, _j, _p, jrun, *_ = runs
    jv = jrun.capture_volume
    tv = PortVolume(port_cameras(jv.camera_array), port_points(jv.image_points), port_world(jv.world_points), device="cpu")
    return jv, tv


def assert_same_volume(tv, jv, tol=1e-12):
    for cid, jc in jv.camera_array.posed_cameras.items():
        np.testing.assert_allclose(tv.camera_array.cameras[cid].rotation, jc.rotation, atol=tol)
        np.testing.assert_allclose(tv.camera_array.cameras[cid].translation, jc.translation, atol=tol)
    np.testing.assert_allclose(tv.world_points.xyz, jv.world_points.xyz, atol=tol)


@pytest.mark.parametrize(
    "op",
    [
        ("align_to_object", (7,), {}),
        ("align_to_object", (0, 0), {}),
        ("rotate", ("x", 30.0), {}),
        ("rotate", ("y", -45.0), {}),
        ("rotate", ("z", 90.0), {}),
        ("translate", (), {"x": 0.1, "y": -0.2, "z": 0.3}),
        ("centered", (), {}),
    ],
    ids=lambda op: f"{op[0]}{op[1]}",
)
def test_anchoring_matches_jax(volumes, op):
    jv, tv = volumes
    name, args, kwargs = op
    assert_same_volume(getattr(tv, name)(*args, **kwargs), getattr(jv, name)(*args, **kwargs))
    np.testing.assert_array_equal(tv.unique_sync_indices, jv.unique_sync_indices)


def test_anchoring_refusals_match_jax(volumes):
    jv, tv = volumes
    for call in (
        lambda v: v.align_to_object(None),
        lambda v: v.align_to_object(None, 0),
        lambda v: v.align_to_object(999),
        lambda v: v.rotate("w", 10.0),
    ):
        with pytest.raises(ValueError) as jerr:
            call(jv)
        with pytest.raises(ValueError, match=str(jerr.value)[:40].replace("(", r"\(").replace(")", r"\)")):
            call(tv)


def test_similarity_ops_match_jax(rng):
    src = rng.normal(size=(12, 3))
    s0, R0 = 1.7, np.asarray(JSim.umeyama(rng.normal(size=(4, 3)), rng.normal(size=(4, 3)))[1])
    dst = s0 * src @ R0.T + np.array([0.3, -0.1, 2.0]) + rng.normal(scale=1e-3, size=src.shape)
    for with_scale in (True, False):
        js, jR, jt = JSim.umeyama(src, dst, with_scale=with_scale)
        ts, tR, tt = TSim.umeyama(src, dst, with_scale=with_scale)
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-12)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-12)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-12)
    X = rng.normal(size=(5, 3))
    np.testing.assert_allclose(
        TSim.apply_similarity_to_points(1.3, R0, [0.1, 0.2, 0.3], X).numpy(),
        np.asarray(JSim.apply_similarity_to_points(1.3, jnp.asarray(R0), jnp.asarray([0.1, 0.2, 0.3]), jnp.asarray(X))),
        atol=1e-12,
    )
    Rc = np.stack([np.asarray(JSim.umeyama(rng.normal(size=(4, 3)), rng.normal(size=(4, 3)))[1]) for _ in range(3)])
    tc = rng.normal(size=(3, 3))
    for got, want in zip(
        TSim.apply_similarity_to_extrinsics(1.3, R0, np.array([0.1, 0.2, 0.3]), Rc, tc),
        JSim.apply_similarity_to_extrinsics(1.3, R0, np.array([0.1, 0.2, 0.3]), Rc, tc),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    p_t, p_j = TSim.SimilarityParams(1.3, R0, np.array([0.1, 0.2, 0.3])), JSim.SimilarityParams(1.3, R0, np.array([0.1, 0.2, 0.3]))
    np.testing.assert_allclose(p_t.matrix(), p_j.matrix(), atol=1e-15)
    np.testing.assert_allclose(p_t.inverse().matrix(), p_j.inverse().matrix(), atol=1e-15)
    np.testing.assert_allclose(p_t.apply(X), p_j.apply(X), atol=1e-15)


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_the_cpu(runs):
    """The 4 x 20 pipeline on the card (float32 BA, the Schur kernel where
    it qualifies) against the port's CPU run: within 0.05 deg / 1 mm after
    both are moved onto the truth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene, _j, (pip, pcams), _jr, _jp, trun, _tp = runs
    card = calibrate_extrinsics(pip, pcams, None)
    assert card.capture_volume.device.type == "cuda"
    truth = port_cameras(scene.cameras)
    for cid in range(4):
        for run in (card, trun):
            assert run.capture_volume.camera_array.cameras[cid].is_posed
    gap = gaps(aligned_to_truth(card.capture_volume.camera_array, truth), aligned_to_truth(trun.capture_volume.camera_array, truth))
    assert len(gap) == 4
    assert max(g[0] for g in gap.values()) <= CARD_VS_CPU_ROTATION_DEG, gap
    assert max(g[1] for g in gap.values()) <= CARD_VS_CPU_CENTER_M, gap
