"""The port's host shell as a user drives it: a small full workflow through
caliscope_tpu_torch.__main__ (the CLI, in process, --device cpu) on a
workspace of rendered recordings, held to the JAX package's Workspace on
the same folders.

The workspace is chip_smoke.py's recipe (tests/test_workspace_e2e.py's rig)
cut to what the CPU can track within a test's time: cameras 0 and 1 of the
ring at 512x288 (f scaled with the width), 4 intrinsic views each, 4
extrinsic frames at sweep stations both cameras see, a 2-frame recording.
Held:
- the skeleton `init` writes, and the files `Workspace.create` and the
  target repositories write, are the JAX package's byte for byte;
- after the workflow, the files are the ones the JAX Workspace names, in
  its places (its xy CSV path, capture-volume folder, intrinsic reports,
  and the reconstruction outputs the JAX package's reconstruct_xyz writes
  for the same recording), and the JAX package reads them: its workflow
  status equals the port's, its `status` command prints the same lines, its
  capture volume has the port's RMSE (1e-9), its reconstruction the port's
  points (1e-9 m);
- the device travels: without --device the CLI asks for CUDA and raises
  here, `gui` too, and `gui --device cpu` opens the project in the
  headless GUI;
- logging and the workspace watcher behave as the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import logging
import sys
import time

import numpy as np
import pytest

import chip_smoke as cs
from caliscope_tpu import __main__ as jax_cli
from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.reconstruction import reconstruct_xyz as jax_reconstruct_xyz
from caliscope_tpu.repositories import TargetRouting as JaxTargetRouting
from caliscope_tpu.targets import Charuco as JaxCharuco
from caliscope_tpu.trackers import CharucoTracker as JaxCharucoTracker
from caliscope_tpu.workspace import Workspace as JaxWorkspace

from caliscope_tpu_torch import __main__ as cli
from caliscope_tpu_torch import api as port_api
from caliscope_tpu_torch.logger import setup_logging
from caliscope_tpu_torch.media.video import write_gray_video
from caliscope_tpu_torch.observations import WorldPoints
from caliscope_tpu_torch.repositories import TargetRouting
from caliscope_tpu_torch.workspace import StepStatus, Workspace, WorkspaceWatcher
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

WH = (512, 288)
F = 900.0 * WH[0] / 640
SQ_PX = 84 * WH[0] // 640
CAMS = (0, 1)
STATION_AZ_DEG = (290.0, 305.0, 320.0, 335.0)  # faces both camera 0 (az 0) and camera 1 (az 90)
RECORDING_AZ_DEG = (300.0, 325.0)


@contextlib.contextmanager
def _quiet_cli():
    """The CLI configures the package's logging and the process's
    excepthook; undo both after it ran."""
    hook = sys.excepthook
    try:
        yield
    finally:
        sys.excepthook = hook
        for h in logging.getLogger("caliscope_tpu_torch").handlers:
            h.close()
        logging.getLogger("caliscope_tpu_torch").handlers.clear()
        logging.getLogger("caliscope_tpu").handlers.clear()


def _run(main, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(map(str, argv)))
    assert rc == 0, argv
    return out.getvalue()


def _render(root):
    cams = {c: v for c, v in cs.ws_cameras(4, WH, F).items() if c in CAMS}
    board_img = cs.ws_board().board_image(px_per_square=SQ_PX, margin_squares=0.5)
    intrinsic = cs.ws_intrinsic_poses(cams, 4)
    stations = [cs._sweep_pose(np.radians(a), 3 * k, 12, k) for k, a in enumerate(STATION_AZ_DEG)]
    recording = [cs._sweep_pose(np.radians(a), k, 12, 0) for k, a in enumerate(RECORDING_AZ_DEG)]
    for cid, cam in cams.items():
        for folder, poses in (("calibration/intrinsic", intrinsic[cid]), ("calibration/extrinsic", stations),
                              ("recordings/rec0", recording)):
            write_gray_video(root / folder / f"cam_{cid}.mp4", [cs.ws_render(board_img, SQ_PX, cam, p, WH) for p in poses])
    return cams


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """The port's workflow through its CLI, once for the module."""
    n = __import__("torch").get_num_threads()
    __import__("torch").set_num_threads(1)
    root = tmp_path_factory.mktemp("ws") / "proj"
    printed = {}
    extracted = []  # each multicam extraction's points: the last is the recording's, for the JAX reconstruction
    multicam = port_api.extract_image_points_multicam

    def recorded(*args, **kwargs):
        extracted.append(multicam(*args, **kwargs))
        return extracted[-1]

    port_api.extract_image_points_multicam = recorded
    try:
        with _quiet_cli():
            printed["init"] = _run(cli.main, "init", root, "--device", "cpu")
            ws = Workspace(root, device="cpu")
            ws.targets.save_intrinsic_charuco(cs.ws_board())
            ws.targets.save_routing(TargetRouting(intrinsic="charuco", extrinsic="charuco"))
            cams = _render(root)
            printed["status_before"] = _run(cli.main, "status", root, "--device", "cpu")
            for step, *args in (("calibrate-intrinsics", "--frame-step", "1"), ("extract",), ("calibrate-extrinsics",),
                                ("reconstruct", "rec0"), ("status",)):
                printed[step] = _run(cli.main, step, root, *args, "--device", "cpu")
    finally:
        port_api.extract_image_points_multicam = multicam
        __import__("torch").set_num_threads(n)
    printed["recording_points"] = extracted[-1]
    return root, ws, cams, printed


def _files(root, skip=("logs", ".mp4", ".png")):
    return sorted(
        str(p.relative_to(root)) for p in root.rglob("*") if p.is_file() and not any(s in str(p) for s in skip)
    )


def test_skeleton_is_the_jax_packages(tmp_path):
    with _quiet_cli():
        _run(cli.main, "init", tmp_path / "port", "--device", "cpu")
    JaxWorkspace.create(tmp_path / "jax")
    port, jax = Workspace(tmp_path / "port"), JaxWorkspace(tmp_path / "jax")
    port.targets.save_intrinsic_charuco(cs.ws_board())
    jax.targets.save_intrinsic_charuco(JaxCharuco(rows=5, columns=7, square_size_m=0.09))
    port.targets.save_routing(TargetRouting(intrinsic="charuco", extrinsic="charuco"))
    jax.targets.save_routing(JaxTargetRouting(intrinsic="charuco", extrinsic="charuco"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "calibration/targets/config.toml", "calibration/targets/intrinsic_charuco.toml", "project_settings.toml",
    ]
    for name in _files(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    dirs = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*") if p.is_dir())
    assert dirs == sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*") if p.is_dir())


def test_workflow_files_are_where_the_jax_workspace_puts_them(workflow):
    root, ws, cams, _ = workflow
    jws = JaxWorkspace(root)
    rec_out = (root / "recordings" / "rec0" / "CHARUCO").relative_to(root)
    expected = sorted(
        [str(p.relative_to(root)) for p in (jws.settings.path, jws.cameras.path, jws.xy_csv_path("CHARUCO"))]
        + [f"calibration/targets/{n}" for n in ("config.toml", "intrinsic_charuco.toml")]
        + [str((jws.intrinsic_reports.reports_dir / f"cam_{c}.toml").relative_to(root)) for c in CAMS]
        + [str((jws.capture_volume.base_path / n).relative_to(root))
           for n in ("camera_array.toml", "image_points.csv", "world_points.csv", "constraints.toml")]
        + [str(rec_out / n) for n in ("xyz_CHARUCO.csv", "xyz_CHARUCO_labelled.csv", "xyz_CHARUCO.trc")]
    )
    assert _files(root) == expected
    assert (root / "logs" / "caliscope_tpu_torch.log").exists()


def test_the_jax_package_reads_the_workspace(workflow):
    root, ws, cams, printed = workflow
    status = ws.get_workflow_status()
    assert (status.intrinsic_step_status, status.extrinsic_2d_step_status, status.extrinsic_calibration_step_status) == (
        StepStatus.COMPLETE,) * 3
    jstatus = JaxWorkspace(root).get_workflow_status()
    assert {k: v for k, v in dataclasses.asdict(status).items()} == dataclasses.asdict(jstatus)
    with _quiet_cli():
        assert _run(jax_cli.main, "status", root) == printed["status"]
    assert "COMPLETE" in printed["status"] and "NOT_STARTED" in printed["status_before"]
    for cid in CAMS:
        assert ws.intrinsic_reports.load(cid).rmse < 1.0
        np.testing.assert_allclose(ws.cameras.load().cameras[cid].matrix[0, 0], F, rtol=0.03)


def test_capture_volume_and_reconstruction_match_the_jax_package(workflow, tmp_path):
    root, ws, cams, printed = workflow
    volume = ws.capture_volume.load(device="cpu")
    jvolume = JaxWorkspace(root).capture_volume.load()
    rmse = volume.reprojection_report.overall_rmse
    assert rmse < 1.0
    assert jvolume.reprojection_report.overall_rmse == pytest.approx(rmse, rel=1e-9)
    # the points the reconstruct step extracted from the recording, through the
    # JAX package's reconstruction: the same files, the same points
    ip = printed["recording_points"]
    assert sorted(set(ip.cam_id.tolist())) == list(CAMS) and len(ip) > 0
    jip = JaxImagePoints(*(getattr(ip, c) for c in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc", "frame_time")))
    out = tmp_path / "CHARUCO"
    jax_reconstruct_xyz(jip, JaxCameraArray.from_toml(ws.cameras.path), JaxCharucoTracker(JaxCharuco(rows=5, columns=7, square_size_m=0.09)), out)
    port_out = root / "recordings" / "rec0" / "CHARUCO"
    assert sorted(p.name for p in out.iterdir()) == sorted(p.name for p in port_out.iterdir())
    got, want = WorldPoints.from_csv(port_out / "xyz_CHARUCO.csv"), WorldPoints.from_csv(out / "xyz_CHARUCO.csv")
    for c in ("sync_index", "object_id", "keypoint_id"):
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c))
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-9)
    assert len(got) > 0


def test_device_travels_and_gui_is_not_ported(workflow, monkeypatch, tmp_path):
    root, *_ = workflow
    assert Workspace(root, device="cpu").make_extrinsic_tracker().device.type == "cpu"
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Workspace(root).make_intrinsic_tracker()
    with _quiet_cli(), pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["extract", str(root)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["gui", str(root)])
    # `gui --device cpu` opens the project and runs the headless event loop
    # until the application quits (the name is kept from when `gui` raised)
    import threading

    from caliscope_tpu_torch.gui import headless, main_window

    headless.QApplication._reset_for_tests()
    monkeypatch.setattr(main_window, "APP_SETTINGS_PATH", tmp_path / "settings.toml")
    opened = []

    def quit_when_open():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            app = headless.QApplication.instance()
            if app is not None and (tmp_path / "settings.toml").exists():
                opened.append(main_window.load_app_settings(tmp_path / "settings.toml"))
                app.quit()
                return
            time.sleep(0.01)

    stopper = threading.Thread(target=quit_when_open)
    stopper.start()
    try:
        assert cli.main(["gui", str(root), "--device", "cpu"]) == 0
    finally:
        stopper.join()
        headless.QApplication._reset_for_tests()
    assert opened == [{"recent_projects": [str(root)]}]


def test_help_lists_the_jax_commands():
    def commands(main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            main(["--help"])
        return out.getvalue().split("{", 1)[1].split("}", 1)[0]

    assert commands(cli.main) == commands(jax_cli.main)


def test_logging(tmp_path):
    hook = sys.excepthook
    try:
        setup_logging(log_dir=tmp_path, console=True)
        setup_logging(log_dir=tmp_path, console=False)
        assert len(logging.getLogger("caliscope_tpu_torch").handlers) == 1
        logging.getLogger("caliscope_tpu_torch.media").warning("drift detected")
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        for h in logging.getLogger("caliscope_tpu_torch").handlers:
            h.flush()
        text = (tmp_path / "caliscope_tpu_torch.log").read_text()
        assert "WARNING" in text and "drift detected" in text and "Uncaught exception" in text and "boom" in text
    finally:
        sys.excepthook = hook
        for h in logging.getLogger("caliscope_tpu_torch").handlers:
            h.close()
        logging.getLogger("caliscope_tpu_torch").handlers.clear()


def test_watcher_sees_changes(tmp_path):
    ws = Workspace.create(tmp_path / "w", device="cpu")
    seen = []
    watcher = WorkspaceWatcher(ws, seen.append, poll_interval=0.05)
    assert watcher.poll_once() == []
    write_gray_video(ws.video_path("extrinsic", 2), [np.zeros((16, 16), np.uint8)])
    ws.settings.set("fps", 25)
    assert sorted(watcher.poll_once()) == ["extrinsic_videos", "settings"] and seen
    watcher.start()
    watcher.stop()
    assert ws.get_cam_ids() == [2]
