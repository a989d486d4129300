"""The intrinsic-calibration use case (caliscope_tpu_torch.pipelines.
calibrate_intrinsics) held against the JAX package's: on the JAX suite's
single-camera dataset (selection, solve, camera and report), and the slice
as a whole — a dozen rendered ChArUco frames through both packages'
CharucoTracker and then both run_intrinsic_calibration.

The port runs on the CPU in float64 (detection in float32), the JAX package
in x64. On the same observations K agrees within 1e-6 relative, distortion
within 1e-6, RMSE within 1e-9 relative, and the selection and report are
equal. Through the trackers the two packages' corners differ by up to a few
float32 ulps (~6e-5 px here), which moves the solve by about as much times
its sensitivity: K is held within 1e-5 relative and 0.01 px on the
principal point, distortion within 1e-4 (observed ~1e-7 and ~1e-6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.exceptions import CalibrationError as JaxCalibrationError
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.pipelines.calibrate_intrinsics import calibrate_intrinsics as j_calibrate_intrinsics
from caliscope_tpu.pipelines.calibrate_intrinsics import run_intrinsic_calibration as j_run
from caliscope_tpu.targets.charuco import Charuco as JaxCharuco
from caliscope_tpu.trackers.charuco_tracker import CharucoTracker as JaxCharucoTracker

from caliscope_tpu_torch import CalibrationError, ImagePoints, convert
from caliscope_tpu_torch.pipelines import calibrate_intrinsics, run_intrinsic_calibration
from caliscope_tpu_torch.trackers import CharucoTracker
from test_intrinsics import DIST_TRUE, K_TRUE, _single_cam_dataset
from torch_targets_common import posed_board_views

K_RENDER = np.array([[610.0, 0, 322.0], [0, 605.0, 238.0], [0, 0, 1.0]])
RENDER_WH = (640, 480)


def _image_points(fo, fi, syncs, cam_id=0):
    sync, kp, img, obj = [], [], [], []
    for si, o, u in zip(syncs, fo, fi):
        sync += [si] * len(o)
        kp += list(range(len(o)))
        img.append(u)
        obj.append(o)
    n = len(sync)
    return JaxImagePoints(np.array(sync), np.full(n, cam_id), np.zeros(n), np.array(kp), np.concatenate(img), np.concatenate(obj))


def _port_points(jip):
    return convert.image_points({f: getattr(jip, f) for f in convert.IMAGE_POINT_FIELDS})


def _camera(fisheye=False, size=(1280, 720)):
    jcam = JaxCameraData(cam_id=0, size=size, fisheye=fisheye)
    return jcam, convert.camera_data(dataclasses.asdict(jcam))


def _same_output(got, want, k_rtol=1e-6, pp_atol=None, d_atol=1e-6, rmse_rtol=1e-9):
    gc, wc = got.camera, want.camera
    np.testing.assert_allclose(gc.matrix[[0, 1], [0, 1]], wc.matrix[[0, 1], [0, 1]], rtol=k_rtol)
    np.testing.assert_allclose(gc.matrix[:2, 2], wc.matrix[:2, 2], rtol=0 if pp_atol else k_rtol, atol=pp_atol or 0)
    np.testing.assert_allclose(gc.distortions, wc.distortions, atol=d_atol)
    assert (gc.grid_count, gc.fisheye, gc.size, gc.cam_id) == (wc.grid_count, wc.fisheye, wc.size, wc.cam_id)
    assert gc.error == pytest.approx(wc.error, rel=rmse_rtol)
    g, w = dataclasses.asdict(got.report), dataclasses.asdict(want.report)
    assert g.pop("rmse") == pytest.approx(w.pop("rmse"), rel=rmse_rtol)
    assert g == w


@pytest.fixture(scope="module")
def dataset():
    fo, fi, syncs = _single_cam_dataset(K_TRUE, DIST_TRUE, n_frames=40)
    return _image_points(fo, fi, syncs)


@pytest.fixture(scope="module")
def jax_runs(dataset):
    jcam, _ = _camera()
    return {
        "soft_l1": j_run(dataset, jcam, target_frames=30),
        "quadratic_budget_12": j_run(dataset, jcam, target_frames=12, f_scale_px=None),
    }


def test_run_intrinsic_calibration_matches_jax(dataset, jax_runs):
    _, cam = _camera()
    got = run_intrinsic_calibration(_port_points(dataset), cam, target_frames=30, device="cpu")
    _same_output(got, jax_runs["soft_l1"])
    # the greedy coverage phase stops at 15 frames once nothing new is covered
    assert got.report.frames_used == 15 and got.solve.n_frames_bucketed == 16
    assert abs(got.camera.matrix[0, 0] - K_TRUE[0, 0]) / K_TRUE[0, 0] < 0.01
    assert cam.matrix is None  # the input camera is left as it was


def test_quadratic_loss_and_small_budget_match_jax(dataset, jax_runs):
    _, cam = _camera()
    got = run_intrinsic_calibration(_port_points(dataset), cam, target_frames=12, f_scale_px=None, device="cpu")
    _same_output(got, jax_runs["quadratic_budget_12"])


def test_calibrate_intrinsics_on_given_frames_matches_jax(dataset):
    frames = [int(s) for s in np.unique(dataset.sync_index)[::3]]
    want = j_calibrate_intrinsics(dataset, 0, (1280, 720), frames)
    got = calibrate_intrinsics(_port_points(dataset), 0, (1280, 720), frames, device="cpu")
    np.testing.assert_allclose(got.camera_matrix, want.camera_matrix, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.distortions, want.distortions, atol=1e-6)
    assert got.reprojection_error == pytest.approx(want.reprojection_error, rel=1e-9)
    assert got.frames_used == want.frames_used == len(frames)


def test_no_usable_frames_raise_in_both(dataset):
    """Frames of fewer than MIN_CORNERS_PER_FRAME corners give no selection."""
    few = dataset.select(dataset.keypoint_id < 5)
    jcam, cam = _camera()
    with pytest.raises(JaxCalibrationError):
        j_run(few, jcam)
    with pytest.raises(CalibrationError, match="No usable calibration frames"):
        run_intrinsic_calibration(_port_points(few), cam, device="cpu")
    with pytest.raises(CalibrationError, match="No frames with >= 6 corners"):
        calibrate_intrinsics(_port_points(few), 0, (1280, 720), [0, 1], device="cpu")


@pytest.fixture(scope="module")
def rendered():
    """12 ChArUco views through the pinhole K_RENDER, both trackers' packets."""
    jch = JaxCharuco(rows=5, columns=7, square_size_m=0.054)
    ch = convert.charuco(dataclasses.asdict(jch))
    frames, truth = posed_board_views(ch, 60, K_RENDER, RENDER_WH, 12, seed=7)
    return frames, truth, ch, JaxCharucoTracker(jch).get_points_batch(frames)


def _packets_to_points(packets, cls):
    cols = {k: [] for k in ("sync", "obj_id", "kp", "img", "obj")}
    for si, p in enumerate(packets):
        cols["sync"].append(np.full(len(p), si))
        cols["obj_id"].append(p.object_id)
        cols["kp"].append(p.keypoint_id)
        cols["img"].append(p.img_loc)
        cols["obj"].append(p.obj_loc)
    n = sum(len(p) for p in packets)
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    return cls(cat["sync"], np.zeros(n, np.int64), cat["obj_id"], cat["kp"], cat["img"], cat["obj"])


def test_slice_from_rendered_frames_matches_jax(rendered):
    """Frames -> CharucoTracker -> run_intrinsic_calibration in both packages."""
    frames, truth, ch, jpackets = rendered
    packets = CharucoTracker(ch, device="cpu").get_points_batch(frames)
    for p, jp, tr in zip(packets, jpackets, truth):
        np.testing.assert_array_equal(p.keypoint_id, jp.keypoint_id)
        assert len(p) >= 20 and np.abs(p.img_loc - jp.img_loc).max() < 1.5e-4
        assert np.linalg.norm(p.img_loc - tr[p.keypoint_id], axis=1).mean() < 0.3
    jcam, cam = _camera(size=RENDER_WH)
    want = j_run(_packets_to_points(jpackets, JaxImagePoints), jcam)
    got = run_intrinsic_calibration(_packets_to_points(packets, ImagePoints), cam, device="cpu")
    _same_output(got, want, k_rtol=1e-5, pp_atol=0.01, d_atol=1e-4, rmse_rtol=1e-4)
    np.testing.assert_allclose(got.camera.matrix[[0, 1], [0, 1]], K_RENDER[[0, 1], [0, 1]], rtol=0.01)
    np.testing.assert_allclose(got.camera.matrix[:2, 2], K_RENDER[:2, 2], atol=8.0)
    assert abs(got.camera.distortions[0]) < 0.02 and got.report.rmse < 0.5
