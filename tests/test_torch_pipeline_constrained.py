"""The port's constrained production flow (constraints in CaptureVolume and
caliscope_tpu_torch.pipelines.calibrate_extrinsics) held against the JAX
package's and against the truth.

- One constrained optimize of the same bootstrapped volume in both packages
  (the JAX package's fast-tier test_constrained_optimize_improves_rigidity:
  default_ring_scene(4, 10) at 1 px noise, horizontal neighbor ties at the
  board spacing): the JAX package bootstraps once, in x64, in a module
  fixture, and the port starts from that volume's numpy state, in float64
  on the CPU. Cameras within 1e-9 (rotation matrices, translations in m),
  world points within 1e-9 m, rigidity RMSE to 1e-9 relative.
- The port's own pipeline, float64 on the CPU, against the truth on the
  JAX package's headline contract (0.5 deg / 5 mm per camera after Umeyama
  on the camera centers, tests/synthetic/test_production_pipeline.py) and
  its 2 mm rigidity limit: a two-sided board (two_sided_ring_scene(), cross-
  face ties active) and static markers on the sparse row layout
  (ring_with_static_markers(4, 20), no marker dropped).
- The guards: thickness drift, uncoupled faces, a static marker that moved.
- save/load with constraints.toml.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from caliscope_tpu.constraints import ConstraintSet as JCS
from caliscope_tpu.constraints import DistanceConstraint as JDC
from caliscope_tpu.synthetic.camera_synthesizer import strip_extrinsics as jax_strip_extrinsics
from caliscope_tpu.synthetic.factories import default_ring_scene as jax_ring_scene
from caliscope_tpu.volume import CaptureVolume as JaxVolume

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.constraints import ConstraintSet, DistanceConstraint
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX
from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host
from caliscope_tpu_torch.ops.similarity import SimilarityParams, umeyama
from caliscope_tpu_torch.pipelines import calibrate_extrinsics
from caliscope_tpu_torch.pipelines.calibrate_extrinsics import _count_active_cross_face_ties
from caliscope_tpu_torch.synthetic.calibration_object import CalibrationObject
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import ring_with_static_markers, two_sided_ring_scene
from caliscope_tpu_torch.synthetic.scene import SyntheticScene
from caliscope_tpu_torch.synthetic.trajectory import Trajectory
from caliscope_tpu_torch.volume import CaptureVolume
from torch_pose_common import port_cameras, port_points, port_world

ROTATION_TOL_DEG = 0.5
TRANSLATION_TOL_M = 0.005
RIGIDITY_TOL_MM = 2.0
STATE_TOL = 1e-9


def center(cam):
    return -cam.rotation.T @ cam.translation


def rig_errors(volume, truth):
    """Per posed camera (rotation deg, center m) against the truth after
    Umeyama (with scale) on the camera centers."""
    posed = sorted(volume.camera_array.posed_cameras)
    src = np.array([center(volume.camera_array.cameras[c]) for c in posed])
    dst = np.array([center(truth.cameras[c]) for c in posed])
    s, R, t = umeyama(src, dst)
    aligned = volume._apply_similarity(SimilarityParams(float(s), R.numpy(), t.numpy()))
    return {
        c: (
            float(np.degrees(rotation_geodesic_angle_host(aligned.camera_array.cameras[c].rotation, truth.cameras[c].rotation))),
            float(np.linalg.norm(center(aligned.camera_array.cameras[c]) - center(truth.cameras[c]))),
        )
        for c in posed
    }


def assert_meets_contract(run, scene):
    volume = run.capture_volume
    assert len(volume.camera_array.posed_cameras) == len(scene.cameras.cameras)
    errors = rig_errors(volume, scene.cameras)
    assert max(e[0] for e in errors.values()) <= ROTATION_TOL_DEG, errors
    assert max(e[1] for e in errors.values()) <= TRANSLATION_TOL_M, errors
    assert volume.reprojection_report.overall_rmse < 1.0


def board_truss(scene, spacing=0.054, sigma_m=0.002):
    return ConstraintSet(ConstraintSet._truss_constraints(scene.objects[0].points_local, spacing, sigma_m), frozenset())


def static_marker_set(scene, static_objects):
    """The board truss plus every static marker's six corner distances, the
    markers declared static (tests/synthetic/test_production_pipeline.py)."""
    cons = list(board_truss(scene).distances)
    for obj in static_objects:
        pts = obj.points_local
        for i in range(len(pts)):
            for j in range(i + 1, len(pts)):
                cons.append(DistanceConstraint(obj.object_id, i, obj.object_id, j, float(np.linalg.norm(pts[i] - pts[j])), 0.002))
    return ConstraintSet(tuple(cons), frozenset(o.object_id for o in static_objects))


# ---------------------------------------------------------------------------
# One constrained optimize in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_volumes():
    """(JAX constraint set, bootstrapped volume, unconstrained and
    constrained optimize)."""
    scene = jax_ring_scene(noise_sigma_px=0.5, n_frames=10)
    ip = scene.image_points_noisy(sigma_px=1.0)
    board = scene.objects[0]
    pts = board.points_local
    cons = []
    for a in range(board.n_keypoints):
        for b in range(a + 1, board.n_keypoints):
            d = np.linalg.norm(pts[a] - pts[b])
            if abs(d - 0.054) < 1e-9:
                cons.append(JDC(0, a, 0, b, float(d), 0.002))
    cs = JCS(tuple(cons), frozenset())
    boot = JaxVolume.bootstrap(ip, jax_strip_extrinsics(scene.cameras), constraints=cs)
    return cs, boot, boot.optimize(use_constraints=False), boot.optimize(use_constraints=True)


def port_volume(jax_volume, cs):
    return CaptureVolume(
        port_cameras(jax_volume.camera_array), port_points(jax_volume.image_points), port_world(jax_volume.world_points),
        constraints=convert.constraint_set(dataclasses.asdict(cs)), device="cpu",
    )


@pytest.mark.parametrize("use_constraints", [False, True], ids=["unconstrained", "constrained"])
def test_optimize_matches_jax(jax_volumes, use_constraints):
    cs, boot, *want = jax_volumes
    want = want[use_constraints]
    got = port_volume(boot, cs).optimize(use_constraints=use_constraints)
    assert got.optimization_status.iterations == want.optimization_status.iterations
    np.testing.assert_allclose(got.optimization_status.final_cost, want.optimization_status.final_cost, rtol=1e-9)
    for cid, jc in want.camera_array.cameras.items():
        np.testing.assert_allclose(got.camera_array.cameras[cid].rotation, jc.rotation, atol=STATE_TOL, rtol=0)
        np.testing.assert_allclose(got.camera_array.cameras[cid].translation, jc.translation, atol=STATE_TOL, rtol=0)
    np.testing.assert_allclose(got.world_points.xyz, want.world_points.xyz, atol=STATE_TOL, rtol=0)
    got_rep, want_rep = got.rigidity_report(), want.rigidity_report()
    assert got_rep.n_violations == want_rep.n_violations > 0
    np.testing.assert_allclose(got_rep.rmse_mm, want_rep.rmse_mm, rtol=1e-9)
    assert got.constraints == port_volume(boot, cs).constraints  # carried through optimize


def test_constraints_improve_rigidity(jax_volumes):
    """The JAX package's contract, on the port: constrained rigidity no
    worse than unconstrained, and under 2 mm."""
    cs, boot, *_ = jax_volumes
    v = port_volume(boot, cs)
    r_unc = v.optimize(use_constraints=False).rigidity_report().rmse_mm
    r_con = v.optimize(use_constraints=True).rigidity_report().rmse_mm
    assert r_con <= r_unc and r_con < RIGIDITY_TOL_MM


def test_save_load_with_constraints_toml(jax_volumes, tmp_path):
    cs, boot, _unc, want = jax_volumes
    v = port_volume(boot, cs).optimize()
    v.save(tmp_path / "cv")
    want.save(tmp_path / "jax_cv")
    assert (tmp_path / "cv" / "constraints.toml").read_bytes() == (tmp_path / "jax_cv" / "constraints.toml").read_bytes()
    loaded = CaptureVolume.load(tmp_path / "cv", device="cpu")
    assert loaded.constraints == v.constraints
    np.testing.assert_array_equal(loaded.world_points.xyz, v.world_points.xyz)
    assert loaded.reprojection_report.overall_rmse == pytest.approx(v.reprojection_report.overall_rmse, abs=1e-9)
    assert loaded.rigidity_report().rmse_mm == pytest.approx(v.rigidity_report().rmse_mm, rel=1e-12)
    # the JAX package's files load into the port too
    jl = CaptureVolume.load(tmp_path / "jax_cv", device="cpu")
    assert jl.constraints == v.constraints
    np.testing.assert_allclose(jl.world_points.xyz, want.world_points.xyz, atol=0)
    # without constraints no constraints.toml is written or read
    bare = CaptureVolume(v.camera_array, v.image_points, v.world_points, device="cpu")
    bare.save(tmp_path / "bare")
    assert not (tmp_path / "bare" / "constraints.toml").exists()
    assert CaptureVolume.load(tmp_path / "bare", device="cpu").constraints is None


# ---------------------------------------------------------------------------
# The port's pipeline against the truth
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_sided():
    scene, ch = two_sided_ring_scene()
    return scene, ch, scene.image_points_noisy()


def test_two_sided_board_pipeline(two_sided):
    scene, ch, ip = two_sided
    assert set(np.unique(ip.object_id)) == {0, 1}
    cs = ConstraintSet.from_charuco(ch)
    run = calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), cs, refine_intrinsics=False, device="cpu")
    assert_meets_contract(run, scene)
    assert _count_active_cross_face_ties(run.capture_volume, cs) > 0
    rigidity = run.capture_volume.rigidity_report()
    assert rigidity.n_violations > 0 and rigidity.rmse_mm < RIGIDITY_TOL_MM
    assert run.capture_volume.constraints == cs and run.dropped_static_markers == ()


def test_static_markers_pipeline_on_the_sparse_layout(monkeypatch):
    """Static markers collapse every frame's view of a corner onto one
    point: duplicate (point, camera) pairs, so each BA stage runs the
    sparse row layout."""
    from caliscope_tpu_torch.solvers import bundle as TB

    scene = ring_with_static_markers(4, 20)
    cs = static_marker_set(scene, scene.objects[1:])
    problems = []
    make_problem = TB.make_problem
    monkeypatch.setattr(TB, "make_problem", lambda *a, **k: problems.append(1) or make_problem(*a, **k))
    run = calibrate_extrinsics(scene.image_points_noisy(), strip_extrinsics(scene.cameras), cs, refine_intrinsics=False, device="cpu")
    assert len(problems) == 3  # linear, robust and final BA
    assert run.dropped_static_markers == ()
    assert_meets_contract(run, scene)
    wp = run.capture_volume.world_points
    assert set(wp.object_id[wp.sync_index == STATIC_SYNC_INDEX]) == {100, 101, 102}
    assert run.capture_volume.rigidity_report().rmse_mm < RIGIDITY_TOL_MM
    # a static marker anchors the volume without a sync index
    anchored = run.capture_volume.align_to_object(None, 100)
    rows = (anchored.world_points.object_id == 100) & (anchored.world_points.sync_index == STATIC_SYNC_INDEX)
    np.testing.assert_allclose(anchored.world_points.xyz[rows].mean(0), 0.0, atol=2e-3)
    with pytest.raises(ValueError, match="STATIC"):
        run.capture_volume.align_to_object(None, 0)


def test_moving_static_marker_is_dropped():
    """A marker declared static that orbits with the board wobbles far past
    a quarter of its span: the review drops it, rebuilds the network
    without it, and the rig still meets the contract."""
    scene = ring_with_static_markers(4, 20, n_static_markers=2)
    moving = scene.objects[2]
    objects = list(scene.objects)
    trajectories = list(scene.trajectories)
    trajectories[2] = Trajectory.orbital(scene.n_frames, radius=0.3, height_amplitude=0.2, tilt_amplitude=0.3)
    objects[2] = CalibrationObject.from_points(moving.object_id, moving.points_local, static=True)
    scene = SyntheticScene(scene.cameras, objects, trajectories, noise_sigma_px=0.5, seed=42)
    cs = static_marker_set(scene, scene.objects[1:])
    run = calibrate_extrinsics(scene.image_points_noisy(), strip_extrinsics(scene.cameras), cs, refine_intrinsics=False, device="cpu")
    assert run.dropped_static_markers == (moving.object_id,)
    assert moving.object_id not in run.capture_volume.constraints.static_object_ids
    assert moving.object_id not in set(run.capture_volume.image_points.object_id)
    assert_meets_contract(run, scene)


def test_thickness_drift_is_refused(two_sided):
    scene, ch, ip = two_sided
    drifted = ConstraintSet.from_charuco(dataclasses.replace(ch, thickness_m=0.008))
    seen = []
    with pytest.raises(CalibrationError, match="Thickness drift"):
        calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), drifted, progress=lambda p, s: seen.append(s), device="cpu")
    assert seen == ["Preparing cameras"]
    single = ConstraintSet.from_charuco(dataclasses.replace(ch, thickness_m=0.0))
    with pytest.raises(CalibrationError, match="configured as 0"):
        calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), single, device="cpu")
    front_only = ip.select(ip.object_id == 0)
    with pytest.raises(CalibrationError, match="no back-face rows"):
        calibrate_extrinsics(front_only, strip_extrinsics(scene.cameras), ConstraintSet.from_charuco(ch), device="cpu")


def test_uncoupled_faces_are_refused(two_sided):
    """Back-face rows moved to sync indices where the front face was never
    seen: no cross-face tie can fire, and the bootstrap stage refuses."""
    scene, ch, ip = two_sided
    sync = ip.sync_index.copy()
    sync[ip.object_id == 1] += 10_000
    shifted = convert.image_points(
        dict(sync_index=sync, cam_id=ip.cam_id, object_id=ip.object_id, keypoint_id=ip.keypoint_id,
             img_xy=ip.img_xy, obj_loc=ip.obj_loc)
    )
    seen = []
    with pytest.raises(CalibrationError, match="never triangulated at the same sync index"):
        calibrate_extrinsics(shifted, strip_extrinsics(scene.cameras), ConstraintSet.from_charuco(ch),
                             progress=lambda p, s: seen.append(s), device="cpu")
    assert seen == ["Preparing cameras", "Bootstrapping poses"]


def test_charuco_constraints_run_on_cuda_by_default(two_sided, monkeypatch):
    """Without device=, the constrained flow asks for CUDA and raises where
    there is none (here), before any work."""
    import torch

    scene, ch, ip = two_sided
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), ConstraintSet.from_charuco(ch))


@pytest.mark.cuda
def test_constrained_pipeline_on_cuda_matches_cpu(two_sided):
    """The two-sided flow on the card (float32) within 0.05 deg / 1 mm of
    the port's CPU run after both are aligned to the truth."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    scene, ch, ip = two_sided
    cs = ConstraintSet.from_charuco(ch)
    runs = {dev: calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), cs, device=dev) for dev in ("cuda", "cpu")}
    errs = {dev: rig_errors(run.capture_volume, scene.cameras) for dev, run in runs.items()}
    for cid, (rot, ctr) in errs["cuda"].items():
        assert abs(rot - errs["cpu"][cid][0]) <= 0.05 and abs(ctr - errs["cpu"][cid][1]) <= 0.001
