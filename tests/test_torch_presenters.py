"""The port's presenters (caliscope_tpu_torch/presenters/): their state
machines against the JAX package's on the same inputs, on the CPU.

Each pair of presenters is driven the same way and must emit the same
sequence of states. Where the work behind a transition is a calibration,
the JAX presenter's work function is replaced by one that returns (or
raises) at once, since the transitions and not the JAX package's solve are
compared (its extrinsic calibration compiles for tens of seconds); the
port's presenters run their real work: calibrate_extrinsics on a 4-camera
synthetic ring, extraction and intrinsic calibration from a rendered
video, the streaming extraction and reconstruction. The multicamera
processing presenters run their real work on both sides and must give the
same points.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest

import caliscope_tpu.api as JA
import caliscope_tpu.presenters.extrinsic as JEX
import caliscope_tpu.reconstruction as JREC
from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.presenters import ExtrinsicCalibrationPresenter as JaxExtrinsic
from caliscope_tpu.presenters import IntrinsicCalibrationPresenter as JaxIntrinsic
from caliscope_tpu.presenters import MultiCameraProcessingPresenter as JaxProcessing
from caliscope_tpu.presenters import ReconstructionPresenter as JaxReconstruction
from caliscope_tpu.targets.charuco import Charuco as JaxCharuco
from caliscope_tpu.trackers.charuco_tracker import CharucoTracker as JaxCharucoTracker

from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.media.video import write_gray_video
from caliscope_tpu_torch.presenters import (
    ExtrinsicCalibrationPresenter,
    ExtrinsicCalibrationState,
    FilterPreviewData,
    IntrinsicCalibrationPresenter,
    IntrinsicCalibrationState,
    MultiCameraProcessingPresenter,
    ProcessingState,
    ReconstructionPresenter,
    Signal,
)
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import default_ring_scene
from caliscope_tpu_torch.trackers import CharucoTracker
from test_torch_streamer import DotTracker, JaxDotTracker, _make_recording
from torch_detect_common import QUAD_FRONT, board_frame, port_board
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _names(states):
    return [s.name for s in states]


def _settle(states, busy: str, timeout=120):
    """Wait for the presenter's last state change to leave `busy`: run(block=
    True) returns when the task's future is set, and the done callback,
    which emits the final state, may run a moment later."""
    deadline = time.time() + timeout
    while (not states or states[-1].name == busy) and time.time() < deadline:
        time.sleep(0.02)


@pytest.fixture(scope="module")
def scene():
    s = default_ring_scene(4, 8)
    return s, s.image_points_noisy(), strip_extrinsics(s.cameras)


@pytest.fixture(scope="module")
def calibrated(scene):
    """The port's extrinsic presenter after a real calibration, its states
    and progress."""
    _, ip, cams = scene
    p = ExtrinsicCalibrationPresenter(ip, cams, None, device="cpu")
    states, progress = [], []
    p.state_changed.connect(states.append)
    p.progress_updated.connect(lambda pct, msg: progress.append(pct))
    p.set_refine_intrinsics(False)
    p.run_calibration(block=True)
    _settle(states, "CALIBRATING")
    return p, states, progress


def test_extrinsic_transitions_match_jax(calibrated, scene, monkeypatch):
    p, states, progress = calibrated
    _, ip, _ = scene
    assert p.state is ExtrinsicCalibrationState.CALIBRATED and p.capture_volume is not None
    assert progress and progress[-1] == 100
    assert p.capture_volume.reprojection_report.overall_rmse < 1.0

    run = types.SimpleNamespace(capture_volume=object())
    monkeypatch.setattr(JEX, "calibrate_extrinsics", lambda *a, **k: run)
    jcams = JaxCameraArray({c: JaxCameraData(c, cam.size) for c, cam in scene[2].cameras.items()})
    jp = JaxExtrinsic(ip, jcams, None)
    jstates = []
    jp.state_changed.connect(jstates.append)
    jp.run_calibration(block=True)
    _settle(jstates, "CALIBRATING")
    assert _names(states) == _names(jstates) == ["CALIBRATING", "CALIBRATED"]

    # a calibration that fails, on both sides
    def boom(*a, **k):
        raise ValueError("no")

    monkeypatch.setattr(JEX, "calibrate_extrinsics", boom)
    for presenter in (ExtrinsicCalibrationPresenter(ip, CameraArray({}), None, device="cpu"), JaxExtrinsic(ip, jcams, None)):
        seen, errors = [], []
        presenter.state_changed.connect(seen.append)
        presenter.error_occurred.connect(errors.append)
        presenter.run_calibration(block=True)
        _settle(seen, "CALIBRATING")
        assert _names(seen) == ["CALIBRATING", "FAILED"] and errors


def test_extrinsic_no_data_matches_jax():
    for presenter, state in ((ExtrinsicCalibrationPresenter(None, None, None, device="cpu"), ExtrinsicCalibrationState),
                             (JaxExtrinsic(None, None, None), None)):
        assert presenter.state.name == "NO_DATA"
        assert presenter.run_calibration() is None
        assert presenter.state.name == "FAILED"
        assert presenter.get_filter_preview().percent_above_threshold(1.0) == 0.0


def test_post_calibration_operations(calibrated, scene):
    p, _, _ = calibrated
    _, ip, _ = scene
    volumes = []
    p.capture_volume_changed.connect(volumes.append)
    preview = p.get_filter_preview()
    assert len(preview.errors) > 0 and 0 <= preview.percent_above_threshold(0.5) <= 100
    assert preview.percentile_error(50) <= preview.percentile_error(95)
    r0 = p.capture_volume.reprojection_report.overall_rmse
    p.rotate("z", 45.0)
    assert volumes[-1].reprojection_report.overall_rmse == pytest.approx(r0, rel=1e-6)
    options = p.get_origin_options()
    assert options and options[0].object_id == 0
    p.align_to_origin(options[0].object_id, options[0].sync_index)
    p.translate(0.1, 0.0, 0.0)
    p.center()
    p.filter_by_percentile(5.0)
    assert len(volumes) == 5 and p.state is ExtrinsicCalibrationState.CALIBRATED
    assert len(p.capture_volume.image_points) < len(ip)
    assert FilterPreviewData.empty().percentile_error(50) == 0.0


@pytest.fixture(scope="module")
def intrinsic_video(tmp_path_factory):
    d = tmp_path_factory.mktemp("intr")
    jch = JaxCharuco(rows=5, columns=7, square_size_m=0.054)
    ch = port_board(jch)
    rng = np.random.default_rng(8)
    frames = [board_frame(ch, np.array(QUAD_FRONT) + rng.uniform(-12, 12, (4, 2)), noise_seed=i)[0] for i in range(6)]
    write_gray_video(d / "cam_0.mp4", frames)
    return d / "cam_0.mp4", ch, jch


def test_intrinsic_transitions_match_jax(intrinsic_video, monkeypatch, tmp_path):
    video, ch, jch = intrinsic_video
    p = IntrinsicCalibrationPresenter(CameraData(0, (320, 240)), video, CharucoTracker(ch, device="cpu"), frame_step=1, device="cpu")
    states, done = [], []
    p.state_changed.connect(states.append)
    p.calibration_completed.connect(done.append)
    assert p.state is IntrinsicCalibrationState.READY
    p.run(block=True)
    _settle(states, "CALIBRATING")
    assert p.state is IntrinsicCalibrationState.CALIBRATED and done and p.output.report.frames_used > 0

    out = types.SimpleNamespace(report=None, camera=None)
    monkeypatch.setattr(JA, "extract_image_points", lambda *a, **k: "points")
    monkeypatch.setattr(JA, "calibrate_intrinsics", lambda points, camera: out)
    jp = JaxIntrinsic(JaxCameraData(0, (320, 240)), video, JaxCharucoTracker(jch), frame_step=1)
    jstates = []
    jp.state_changed.connect(jstates.append)
    jp.run(block=True)
    _settle(jstates, "CALIBRATING")
    assert _names(states) == _names(jstates) == ["EXTRACTING", "CALIBRATING", "CALIBRATED"]

    missing = IntrinsicCalibrationPresenter(CameraData(0, (320, 240)), tmp_path / "none.mp4", CharucoTracker(ch, device="cpu"))
    jmissing = JaxIntrinsic(JaxCameraData(0, (320, 240)), tmp_path / "none.mp4", JaxCharucoTracker(jch))
    assert missing.state.name == jmissing.state.name == "NO_VIDEO"
    assert missing.run() is None and jmissing.run() is None


def test_intrinsic_display_queue_is_not_ported(intrinsic_video):
    video, ch, _ = intrinsic_video
    p = IntrinsicCalibrationPresenter(CameraData(0, (320, 240)), video, CharucoTracker(ch, device="cpu"),
                                      display_queue=object(), device="cpu")
    errors, states = [], []
    p.error_occurred.connect(errors.append)
    p.state_changed.connect(states.append)
    p.run(block=True)
    _settle(states, "EXTRACTING")
    assert p.state is IntrinsicCalibrationState.FAILED and "item 26" in errors[0]


def test_processing_presenters_match_jax(tmp_path, monkeypatch):
    rec = _make_recording(tmp_path, cam_ids=(0, 1), n_frames=6)
    cams = CameraArray({c: CameraData(c, (96, 64)) for c in (0, 1)})
    jcams = JaxCameraArray({c: JaxCameraData(c, (96, 64)) for c in (0, 1)})
    results = []
    for presenter in (MultiCameraProcessingPresenter(rec, cams, DotTracker()), JaxProcessing(rec, jcams, JaxDotTracker())):
        seen, frames = [], []
        presenter.state_changed.connect(seen.append)
        presenter.frame_data_ready.connect(lambda si, fd: frames.append(si))
        presenter.run(block=True)
        _settle(seen, "PROCESSING")
        assert _names(seen) == ["PROCESSING", "COMPLETE"]
        results.append((presenter.image_points, frames))
    (got, got_frames), (want, want_frames) = results
    assert got_frames == want_frames == list(range(6))
    for c in ("sync_index", "cam_id", "keypoint_id", "img_xy"):
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c))
    assert ProcessingState.COMPLETE.name == "COMPLETE"

    # reconstruction: the port triangulates for real, the JAX presenter's work returns at once
    monkeypatch.setattr(JREC, "reconstruct_xyz", lambda *a, **k: None)
    scene = default_ring_scene(3, 4)
    seen_all = []
    for presenter, points in ((ReconstructionPresenter(scene.cameras, DotTracker(), tmp_path / "out", device="cpu"),
                               scene.image_points_noisy()),
                              (JaxReconstruction(jcams, JaxDotTracker(), tmp_path / "jout"), None)):
        seen = []
        presenter.state_changed.connect(seen.append)
        assert presenter.state.name == "IDLE"
        presenter.run(points, block=True)
        _settle(seen, "PROCESSING")
        seen_all.append(_names(seen))
    assert seen_all[0] == seen_all[1] == ["PROCESSING", "COMPLETE"]
    assert (tmp_path / "out" / "xyz_DOT.csv").exists()


def test_signal_isolates_subscribers():
    s, got = Signal("x"), []
    s.connect(lambda v: 1 / 0)
    s.connect(got.append)
    s.emit(3)
    s.disconnect(got.append)
    s.emit(4)
    assert got == [3]
