"""The port's first slice as a whole: the production stage schedule after the
bootstrap (linear BA, robust BA with intrinsics, percentile filter, final
BA) through caliscope_tpu_torch.CaptureVolume, held against
caliscope_tpu.CaptureVolume on the same bootstrapped state, plus the
TOML/CSV round trip between the two packages.

Both sides run float64 on the CPU (the JAX side with x64 from conftest).
Tolerances: the two packages evaluate the same expressions in different
summation orders (einsum contraction order, closed-form vs forward-mode
Jacobians), so results agree to roundoff amplified by the LM steps; 1e-7
relative on cost and 1e-7 absolute on poses and points (meters, radians)
is several orders above what was observed and far below anything a
calibration would notice. Iteration counts and the kept observation set
must match exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

from caliscope_tpu.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu.synthetic.factories import default_ring_scene
from caliscope_tpu.volume import CaptureVolume as JaxVolume

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.volume import CaptureVolume as TorchVolume

COST_RTOL = 1e-7
GEOM_ATOL = 1e-7


@pytest.fixture(scope="module")
def boot_volume(tmp_path_factory):
    """The bootstrapped 4-camera ring volume of tests/test_capture_volume.py
    (same cache key and computation, so one run computes it once)."""
    from tests.fixture_cache import per_run_cached

    scene = default_ring_scene(noise_sigma_px=0.5, n_frames=10)

    def compute():
        return JaxVolume.bootstrap(scene.image_points_noisy(), strip_extrinsics(scene.cameras))

    return per_run_cached(tmp_path_factory, "capture_volume_boot", compute)


def _export(volume):
    """The JAX volume's state as plain numpy arrays -> the port's objects."""
    cams = {
        cid: {f: getattr(c, f) for f in convert.CAMERA_FIELDS}
        for cid, c in volume.camera_array.cameras.items()
    }
    ip = {f: getattr(volume.image_points, f) for f in convert.IMAGE_POINT_FIELDS}
    wp = {f: getattr(volume.world_points, f) for f in convert.WORLD_POINT_FIELDS}
    return convert.camera_array(cams), convert.image_points(ip), convert.world_points(wp)


STAGES = [
    ("linear", lambda v, solver: v.optimize(solver=solver)),
    (
        "robust",
        lambda v, solver: v.optimize(
            loss="soft_l1", f_scale=v.pixel_f_scale(1.0), max_nfev=200, ftol=1e-4, strict=False,
            refine_intrinsics=True, solver=solver,
        ),
    ),
    ("filter", lambda v, solver: v.filter_by_percentile_error(2.5)),
    ("final", lambda v, solver: v.optimize(refine_intrinsics=True, solver=solver)),
]


def _run_stages(volume, solver):
    out = []
    for name, stage in STAGES:
        volume = stage(volume, solver)
        out.append((name, volume))
    return out


@pytest.fixture(scope="module", params=["auto", "schur"])
def schedules(request, boot_volume):
    solver = request.param
    cams, ip, wp = _export(boot_volume)
    port = TorchVolume(cams, ip, wp, device="cpu")
    return solver, _run_stages(boot_volume, solver), _run_stages(port, solver)


@pytest.mark.parametrize("stage", range(len(STAGES)), ids=[s[0] for s in STAGES])
def test_stage_matches_jax(schedules, stage):
    _solver, jax_runs, port_runs = schedules
    name, jv = jax_runs[stage]
    _, tv = port_runs[stage]
    assert tv.device.type == "cpu"
    # the same observations survive (exactly)
    for col in ("sync_index", "cam_id", "object_id", "keypoint_id"):
        np.testing.assert_array_equal(getattr(tv.image_points, col), getattr(jv.image_points, col))
    np.testing.assert_array_equal(tv.world_points.keys(), jv.world_points.keys())
    if name != "filter":
        js, ts = jv.optimization_status, tv.optimization_status
        assert ts.iterations == js.iterations
        assert ts.converged == js.converged
        np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=COST_RTOL)
    for cid, jc in jv.camera_array.cameras.items():
        tc = tv.camera_array.cameras[cid]
        np.testing.assert_allclose(tc.rotation, jc.rotation, atol=GEOM_ATOL)
        np.testing.assert_allclose(tc.translation, jc.translation, atol=GEOM_ATOL)
        np.testing.assert_allclose(tc.matrix, jc.matrix, rtol=1e-9)
        np.testing.assert_allclose(tc.distortions, jc.distortions, atol=GEOM_ATOL)
    np.testing.assert_allclose(tv.world_points.xyz, jv.world_points.xyz, atol=GEOM_ATOL)
    np.testing.assert_allclose(
        tv.reprojection_report.overall_rmse, jv.reprojection_report.overall_rmse, rtol=1e-7
    )


def test_depth_ratios_match_jax(schedules):
    _solver, jax_runs, port_runs = schedules
    jr = jax_runs[0][1].depth_ratios()
    tr = port_runs[0][1].depth_ratios()
    assert tr.keys() == jr.keys()
    np.testing.assert_allclose([tr[k] for k in jr], [jr[k] for k in jr], rtol=1e-7)


def test_files_round_trip_byte_identical(boot_volume, tmp_path):
    """Files the JAX package writes are read by the port and written back
    byte-identical: the CSVs reproduce the JAX-written source bytes, and the
    camera TOML (whose rvecs are recomputed from the rotation matrices on
    every write) matches what the JAX package itself writes back.

    The JAX package's own CSV re-write is not byte-stable: pandas' default
    float parser is not correctly rounded and moves some values by an ulp
    (ROADMAP.md, faults of the reference). The port parses with Python's
    float(), which is."""
    from caliscope_tpu.cameras import CameraArray as JaxCameras

    from caliscope_tpu_torch.cameras import CameraArray
    from caliscope_tpu_torch.observations import ImagePoints, WorldPoints

    src = tmp_path / "src"
    boot_volume.camera_array.to_toml(src / "camera_array.toml")
    boot_volume.image_points.to_csv(src / "image_points.csv")
    boot_volume.world_points.to_csv(src / "world_points.csv")
    for cls, name in ((ImagePoints, "image_points.csv"), (WorldPoints, "world_points.csv")):
        cls.from_csv(src / name).to_csv(tmp_path / name)
        assert (tmp_path / name).read_bytes() == (src / name).read_bytes()
    JaxCameras.from_toml(src / "camera_array.toml").to_toml(tmp_path / "jax.toml")
    CameraArray.from_toml(src / "camera_array.toml").to_toml(tmp_path / "port.toml")
    assert (tmp_path / "port.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()


def test_entry_points_need_cuda_unless_cpu_is_named(boot_volume):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    cams, ip, wp = _export(boot_volume)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchVolume(cams, ip, wp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ip.triangulate(cams)


def test_constraints_and_sparse_layout_are_not_ported(boot_volume):
    """Both are ported: a volume takes a constraint set (the board's
    neighbour ties) and its optimize reaches the JAX package's on the same
    state; make_problem builds the sparse row layout."""
    import dataclasses

    from caliscope_tpu.constraints import ConstraintSet as JaxConstraintSet
    from caliscope_tpu.constraints import DistanceConstraint

    cams, ip, wp = _export(boot_volume)
    ties = JaxConstraintSet(
        tuple(DistanceConstraint(0, k, 0, k + 1, 0.054, 0.002) for k in range(5)), frozenset()
    )
    jax_volume = JaxVolume(boot_volume.camera_array, boot_volume.image_points, boot_volume.world_points, constraints=ties)
    want = jax_volume.optimize()
    volume = TorchVolume(cams, ip, wp, constraints=convert.constraint_set(dataclasses.asdict(ties)), device="cpu")
    got = volume.optimize()
    assert got.constraints == volume.constraints and got.rigidity_report().n_violations > 0
    np.testing.assert_allclose(got.optimization_status.final_cost, want.optimization_status.final_cost, rtol=COST_RTOL)
    np.testing.assert_allclose(got.world_points.xyz, want.world_points.xyz, atol=GEOM_ATOL)
    from caliscope_tpu_torch.solvers.bundle import make_problem

    K = np.tile(np.eye(3), (2, 1, 1))
    problem = make_problem([1, 0], [0, 0], np.zeros((2, 2)), K, np.zeros((2, 5)), [False, False], device="cpu")
    assert problem.cam_idx.tolist() == [0, 1] and problem.n_constraints == 0