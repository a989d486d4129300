"""The port's GUI (caliscope_tpu_torch/gui) held to the JAX package's, twin
by twin with tests/test_gui.py: every tab and widget driven headlessly on
both packages at once, from the same numpy inputs.

Both packages' headless Qt backends are forced (CALISCOPE_TPU_FORCE_HEADLESS_QT,
as tests/test_gui.py:14 does) and both QApplication singletons are reset
around each test. The port runs with device="cpu", in float64. Compared:
- widget state exactly: texts, enabled tabs, table cells, emitted signals;
- the images the widgets render to numpy pixel for pixel: board preview,
  coverage heatmap, quality charts, 3D playback, lens model, thumbnail;
- the Extrinsics tab's Calibrate end to end against the JAX GUI's volume at
  tests/test_torch_pipeline_constrained.py's tolerances (cameras and points
  1e-9, the cost and the rigidity 1e-9 relative, the same LM iterations).
The calibrated rig is tests/test_gui.py's scene, solved by the port (the
JAX solve takes 35-45 s, and the JAX suite's per-run cache of it is not
ready when the two files start together), and handed to the JAX package's
widgets as the same numbers. The Explorer's two checks run the port only, on the JAX tests' own gates
against the truth (the JAX package's explorer runs take ~60 s each and are
marked slow there). Model downloads use file:// URLs; the thumbnail video
is uncompressed QuickTime (media/video.py::write_gray_video), which both
packages read.
"""

import os
import re
import threading
import time
from pathlib import Path

os.environ["CALISCOPE_TPU_FORCE_HEADLESS_QT"] = "1"

import numpy as np
import pytest

import caliscope_tpu.gui.qt as JQ
import caliscope_tpu.gui.widgets as JW
from caliscope_tpu.gui import headless as jax_headless
from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.observations import WorldPoints as JaxWorldPoints
from caliscope_tpu.synthetic.camera_synthesizer import strip_extrinsics as jax_strip_extrinsics
from caliscope_tpu.targets import Charuco as JaxCharuco
from caliscope_tpu.targets import Chessboard as JaxChessboard
from caliscope_tpu.volume import CaptureVolume as JaxVolume
from caliscope_tpu.workspace import Workspace as JaxWorkspace
from caliscope_tpu.workspace import WorkspaceWatcher as JaxWatcher

import caliscope_tpu_torch.gui.qt as PQ
import caliscope_tpu_torch.gui.widgets as PW
from caliscope_tpu_torch.gui import headless
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import default_ring_scene
from caliscope_tpu_torch.targets import Charuco, Chessboard
from caliscope_tpu_torch.volume import CaptureVolume
from caliscope_tpu_torch.workspace import Workspace, WorkspaceWatcher
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STATE_TOL = 1e-9  # tests/test_torch_pipeline_constrained.py's


class Apps:
    """Both packages' QApplications, pumped together."""

    def __init__(self):
        self.port, self.jax = PQ.QApplication([]), JQ.QApplication([])

    def processEvents(self):
        self.port.processEvents()
        self.jax.processEvents()


@pytest.fixture
def app():
    headless.QApplication._reset_for_tests()
    jax_headless.QApplication._reset_for_tests()
    yield Apps()
    headless.QApplication._reset_for_tests()
    jax_headless.QApplication._reset_for_tests()


def pump(app, until=None, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        app.processEvents()
        if until is None or until():
            return
        if time.monotonic() > deadline:
            raise TimeoutError("GUI condition not reached")
        time.sleep(0.01)


def pixels(label):
    pm = label.pixmap()
    return None if pm is None else pm.image.array


def same_pixels(port_label, jax_label):
    got, want = pixels(port_label), pixels(jax_label)
    assert got is not None and want is not None and got.size > 0
    np.testing.assert_array_equal(got, want)
    return got


def table(t):
    return [[t.item(i, j).text() if t.item(i, j) is not None else None for j in range(t.columnCount())]
            for i in range(t.rowCount())]


@pytest.fixture(scope="module")
def calibrated_volume(tmp_path_factory):
    """tests/test_gui.py's calibrated ring (default_ring_scene at 0.4 px, 8
    frames, bootstrap + optimize), solved by the port in float64 on the CPU
    (~1.5 s), and the same rig as the JAX package's volume: its cameras
    through their TOML file (byte-identical in both packages), its
    observations and points as the same numpy arrays. Both packages'
    widgets see the same numbers."""
    scene = default_ring_scene(noise_sigma_px=0.4, n_frames=8)
    pvol = CaptureVolume.bootstrap(scene.image_points_noisy(), strip_extrinsics(scene.cameras), device="cpu").optimize()
    toml = tmp_path_factory.mktemp("rig") / "camera_array.toml"
    pvol.camera_array.to_toml(toml)
    ip, wp = pvol.image_points, pvol.world_points
    jvol = JaxVolume(
        JaxCameraArray.from_toml(toml),
        JaxImagePoints(ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id, ip.img_xy, ip.obj_loc, ip.frame_time),
        JaxWorldPoints(wp.sync_index, wp.object_id, wp.keypoint_id, wp.xyz, wp.frame_time),
    )
    return pvol, jvol, scene


@pytest.fixture
def workspaces(tmp_path, calibrated_volume):
    """The JAX suite's seeded workspace (cameras with intrinsics and no
    extrinsics, the extraction CSV, the matching 6 x 8 board), once for
    each package."""
    pvol, jvol, _ = calibrated_volume
    pws = Workspace.create(tmp_path / "port" / "ws", device="cpu")
    jws = JaxWorkspace.create(tmp_path / "jax" / "ws")
    pws.targets.save_intrinsic_charuco(Charuco(rows=6, columns=8, square_size_m=0.054))
    jws.targets.save_intrinsic_charuco(JaxCharuco(rows=6, columns=8, square_size_m=0.054))
    pws.cameras.save(strip_extrinsics(pvol.camera_array))
    jws.cameras.save(jax_strip_extrinsics(jvol.camera_array))
    for ws, vol in ((pws, pvol), (jws, jvol)):
        csv = ws.xy_csv_path(ws.targets.get_extrinsic_tracker_name())
        csv.parent.mkdir(parents=True, exist_ok=True)
        vol.image_points.to_csv(csv)
    assert pws.cameras.path.read_bytes() == jws.cameras.path.read_bytes()
    return pws, jws


# ---------------------------------------------------------------------------
# Headless Qt semantics
# ---------------------------------------------------------------------------


class TestHeadlessQt:
    def test_direct_signal_on_gui_thread(self, app):
        for qt in (PQ, JQ):
            hits = []
            b = qt.QPushButton("go")
            b.clicked.connect(lambda: hits.append(1))
            b.click()
            assert hits == [1]

    def test_disabled_button_does_not_fire(self, app):
        for qt in (PQ, JQ):
            hits = []
            b = qt.QPushButton("go")
            b.clicked.connect(lambda: hits.append(1))
            b.setEnabled(False)
            b.click()
            assert hits == []

    def test_cross_thread_emission_is_queued(self, app):
        from caliscope_tpu.gui.bridge import SignalBridge as JaxBridge
        from caliscope_tpu_torch.gui.bridge import SignalBridge

        got = {}
        for key, bridge_cls in (("port", SignalBridge), ("jax", JaxBridge)):
            events = got.setdefault(key, [])
            bridge = bridge_cls(lambda name, args, ev=events: ev.append((name, args, threading.current_thread())))
            t = threading.Thread(target=bridge.forward("worker_done"), args=(42,))
            t.start()
            t.join()
            assert events == []  # not delivered until the GUI thread pumps
        app.processEvents()
        assert got["port"] == got["jax"] == [("worker_done", (42,), threading.main_thread())]

    def test_widget_tree_and_layouts(self, app):
        for qt in (PQ, JQ):
            host = qt.QWidget()
            layout = qt.QVBoxLayout(host)
            inner = qt.QLabel("x")
            layout.addWidget(inner)
            b = qt.QPushButton()
            layout.addWidget(b)
            assert inner.parent() is host
            assert host.findChildren(qt.QPushButton) == [b]

    def test_tabs_enable_disable(self, app):
        states = []
        for qt in (PQ, JQ):
            tabs = qt.QTabWidget()
            tabs.addTab(qt.QWidget(), "A")
            tabs.addTab(qt.QWidget(), "B")
            tabs.setTabEnabled(1, False)
            tabs.setTabEnabled(-1, False)  # Qt silently ignores bad indices
            states.append((tabs.isTabEnabled(0), tabs.isTabEnabled(1), tabs.count()))
        assert states[0] == states[1] == (True, False, 2)


# ---------------------------------------------------------------------------
# Widgets
# ---------------------------------------------------------------------------


class TestWidgets:
    def test_charuco_config_panel_applies_and_persists(self, app):
        panels, received = [], []
        for W, C in ((PW, Charuco), (JW, JaxCharuco)):
            panel = W.CharucoConfigPanel(C(rows=4, columns=5, square_size_m=0.05))
            got = []
            panel.target_changed.connect(got.append)
            panel.rows.setValue(6)
            panel.square_mm.setValue(40.0)
            panel.apply_btn.click()
            panels.append(panel)
            received.append(got)
        (p,), (j,) = received
        assert (p.rows, p.columns, p.square_size_m, p.dictionary) == (j.rows, j.columns, j.square_size_m, j.dictionary)
        assert p.rows == 6 and abs(p.square_size_m - 0.04) < 1e-12
        assert same_pixels(panels[0].preview, panels[1].preview).shape[1] > 0

    def test_charuco_config_panel_rejects_invalid(self, app):
        out = []
        for W, C in ((PW, Charuco), (JW, JaxCharuco)):
            panel = W.CharucoConfigPanel(C(rows=4, columns=5, square_size_m=0.05))
            received = []
            panel.target_changed.connect(received.append)
            panel.rows.setValue(30)
            panel.columns.setValue(30)  # 450 markers exceed every 4X4 dictionary
            panel.apply_btn.click()
            out.append((received, panel.error_label.text(), panel.rows.value(), panel.columns.value()))
        assert out[0] == out[1]
        assert out[0][0] == [] and out[0][1] != ""

    def test_chessboard_panel(self, app):
        got = []
        for W, C in ((PW, Chessboard), (JW, JaxChessboard)):
            panel = W.ChessboardConfigPanel(C(rows=5, columns=7, square_size_m=0.03))
            panel.target_changed.connect(got.append)
            panel.rows.setValue(4)
            panel.apply_btn.click()
        assert len(got) == 2 and got[0].rows == got[1].rows == 4
        assert (got[0].columns, got[0].square_size_m) == (got[1].columns, got[1].square_size_m)

    def test_coverage_heatmap_fraction(self, app, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        widgets = []
        for W, vol in ((PW, pvol), (JW, jvol)):
            w = W.CoverageHeatmapWidget()
            w.set_data(vol.image_points, {int(c.cam_id): c.size for c in vol.camera_array.cameras.values()})
            widgets.append(w)
        for cid in sorted(pvol.camera_array.cameras):
            assert widgets[0].coverage_fraction(cid) == widgets[1].coverage_fraction(cid)
        assert 0.0 < widgets[0].coverage_fraction(min(pvol.camera_array.cameras)) <= 1.0
        same_pixels(widgets[0].canvas, widgets[1].canvas)

    def test_quality_tabs_populate(self, app, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        tabs = []
        for W, vol in ((PW, pvol), (JW, jvol)):
            t = W.CalibrationQualityTabs()
            t.update_from_volume(vol)
            tabs.append(t)
        p, j = tabs
        assert "RMSE" in p.summary.text() and p.summary.text() == j.summary.text()
        assert p.rmse_table.rowCount() == len(pvol.camera_array.cameras)
        assert table(p.rmse_table) == table(j.rmse_table)
        np.testing.assert_array_equal(p.sparkline.bin_counts, j.sparkline.bin_counts)
        assert p.sparkline.bin_counts.sum() > 0

    def test_scale_detail_chart_click_to_seek(self, app, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        charts, clicks = [], []
        for W, vol in ((PW, pvol), (JW, jvol)):
            t = W.CalibrationQualityTabs()
            t.update_from_volume(vol)
            charts.append(t.scale_chart)
        assert pvol.compute_volumetric_scale_accuracy().n_frames_sampled == jvol.compute_volumetric_scale_accuracy().n_frames_sampled > 0
        p, j = charts
        img = p.chart_array
        np.testing.assert_array_equal(img, j.chart_array)
        assert (img != img[0, 0]).any(), "chart should not be a flat field"
        mid = p._w // 2
        assert p.frame_at(mid) == j.frame_at(mid) is not None
        assert p.value_at(mid) == pytest.approx(j.value_at(mid), rel=1e-9) and p.value_at(mid) >= 0
        assert p.frame_at(-1) is None and p.frame_at(p._w + 5) is None
        for chart in charts:
            got = []
            chart.frame_clicked.connect(got.append)
            chart.click(mid)
            clicks.append(got)
            chart.set_cursor(got[0])
        assert clicks[0] == clicks[1] == [p.frame_at(mid)]
        np.testing.assert_array_equal(p.chart_array, j.chart_array)
        assert (p.chart_array != img).any()

    def test_playback_3d_renders_and_scrubs(self, app, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        ws = []
        for W, vol in ((PW, pvol), (JW, jvol)):
            w = W.Playback3DWidget(width=320, height=240)
            w.set_volume(vol)
            ws.append(w)
        img0 = same_pixels(ws[0].canvas, ws[1].canvas).copy()
        assert (img0 != img0[0, 0]).any(), "render should not be a flat field"
        first = ws[0].current_sync_index()
        for w in ws:
            w.slider.setValue(w.slider.maximum())
        assert ws[0].current_sync_index() == ws[1].current_sync_index() != first
        for w in ws:
            w._orbit(45, 0)
        img1 = same_pixels(ws[0].canvas, ws[1].canvas)
        assert (img0 != img1).any(), "orbiting must change the render"

    def test_lens_model_widget(self, app, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        ws = []
        for W, vol in ((PW, pvol), (JW, jvol)):
            cam = sorted(vol.camera_array.cameras.values(), key=lambda c: c.cam_id)[0]
            w = W.LensModelWidget()
            w.update_from_camera(cam)
            ws.append(w)
        assert "fx=" in ws[0].params.text() and ws[0].params.text() == ws[1].params.text()
        same_pixels(ws[0].canvas, ws[1].canvas)

    def test_structural_warnings_flags_isolated_camera(self, app, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        flags = []
        for W, IP, ip in ((PW, ImagePoints, pvol.image_points), (JW, JaxImagePoints, jvol.image_points)):
            w = W.StructuralWarningsWidget()
            w.update_from_points(ip)
            before = w.has_critical
            lone = IP(  # camera 99 shares no frames with anyone -> disconnected
                sync_index=np.concatenate([ip.sync_index, [9999]]),
                cam_id=np.concatenate([ip.cam_id, [99]]),
                object_id=np.concatenate([ip.object_id, [0]]),
                keypoint_id=np.concatenate([ip.keypoint_id, [0]]),
                img_xy=np.vstack([ip.img_xy, [[1.0, 1.0]]]),
            )
            w.update_from_points(lone)
            flags.append((before, w.has_critical))
        assert flags[0] == flags[1]
        assert flags[0] == (False, True)

    def test_step_strip(self, app, workspaces):
        states = []
        for W, ws in zip((PW, JW), workspaces):
            strip = W.CalibrationStepStrip()
            strip.update_status(ws.get_workflow_status())
            states.append({name: strip.step_state(name) for name in strip.STEPS})
        assert states[0] == states[1]
        assert states[0]["Extract"] in ("○", "◐", "●")


# ---------------------------------------------------------------------------
# Main window flow
# ---------------------------------------------------------------------------


def _windows(tmp_path, workspaces=None):
    from caliscope_tpu.gui.main_window import MainWindow as JaxMainWindow
    from caliscope_tpu_torch.gui.main_window import MainWindow

    pws, jws = workspaces if workspaces else (None, None)
    port = MainWindow(workspace_dir=pws.root if pws else None, settings_path=tmp_path / "port_settings.toml",
                      device="cpu")
    jax = JaxMainWindow(workspace_dir=jws.root if jws else None, settings_path=tmp_path / "jax_settings.toml")
    return port, jax


def _tab_states(win):
    return [(win.tabs.tabText(i), win.tabs.isTabEnabled(i)) for i in range(win.tabs.count())]


class TestMainWindow:
    def test_welcome_then_open(self, app, tmp_path, workspaces):
        wins = _windows(tmp_path)
        for win, qt, ws in zip(wins, (PQ, JQ), workspaces):
            assert win.centralWidget() is win.welcome
            qt.QFileDialog.next_path = str(ws.root)
            win.welcome.open_project_requested.emit()
            assert win.ws is not None and win.ws.root == ws.root
            assert win.recent_projects() == [str(ws.root)]
        assert wins[0].ws.device.type == "cpu"
        assert _tab_states(wins[0]) == _tab_states(wins[1]) and wins[0].tabs.count() == 7
        for win in wins:
            win.close()

    def test_tab_gating_follows_workflow(self, app, tmp_path, workspaces):
        from caliscope_tpu_torch.gui.tab_names import TabName

        port, jax = _windows(tmp_path, workspaces)
        assert _tab_states(port) == _tab_states(jax)
        assert port.tabs.isTabEnabled(port.tab_index(TabName.EXTRINSICS))
        assert not port.tabs.isTabEnabled(port.tab_index(TabName.RECONSTRUCT))
        port.close()
        jax.close()

    def test_extract_tab_shows_existing_extraction(self, app, tmp_path, workspaces):
        port, jax = _windows(tmp_path, workspaces)
        assert table(port.extract_tab.obs_table) == table(jax.extract_tab.obs_table)
        n = port.extract_tab.obs_table.rowCount()
        assert n == len(port.ws.get_cam_ids()) or n > 0
        assert "observations" in port.extract_tab.status.text()
        assert port.extract_tab.status.text() == jax.extract_tab.status.text()
        port.close()
        jax.close()

    def test_extrinsic_calibrate_end_to_end(self, app, tmp_path, workspaces):
        """Click Calibrate on both Extrinsics tabs, pump until each worker
        delivers its volume: the port's agrees with the JAX GUI's, every
        panel updated alike and the files were persisted."""
        from caliscope_tpu_torch.gui.tab_names import TabName

        port, jax = _windows(tmp_path, workspaces)
        for win in (port, jax):
            win.extrinsic_tab.refine_box.setChecked(False)  # keep the run fast
            win.extrinsic_tab.calib_btn.click()
        summaries = lambda: [w.extrinsic_tab.summary.text() for w in (port, jax)]  # noqa: E731
        pump(app, until=lambda: all("RMSE" in s or "Error" in s for s in summaries()), timeout=600)
        assert all("RMSE" in s for s in summaries()), summaries()
        got, want = (w.extrinsic_tab.presenter.capture_volume for w in (port, jax))
        assert got.device.type == "cpu"
        assert got.reprojection_report.overall_rmse < 1.0
        assert got.optimization_status.iterations == want.optimization_status.iterations
        np.testing.assert_allclose(got.optimization_status.final_cost, want.optimization_status.final_cost, rtol=STATE_TOL)
        for cid, jc in want.camera_array.cameras.items():
            np.testing.assert_allclose(got.camera_array.cameras[cid].rotation, jc.rotation, atol=STATE_TOL, rtol=0)
            np.testing.assert_allclose(got.camera_array.cameras[cid].translation, jc.translation, atol=STATE_TOL, rtol=0)
        np.testing.assert_allclose(got.world_points.xyz, want.world_points.xyz, atol=STATE_TOL, rtol=0)
        np.testing.assert_allclose(got.rigidity_report().rmse_mm, want.rigidity_report().rmse_mm, rtol=STATE_TOL)
        assert port.extrinsic_tab.summary.text() == jax.extrinsic_tab.summary.text()
        assert table(port.extrinsic_tab.quality.rmse_table) == table(jax.extrinsic_tab.quality.rmse_table)
        same_pixels(port.extrinsic_tab.playback.canvas, jax.extrinsic_tab.playback.canvas)
        assert port.ws.capture_volume.exists()
        assert port.tabs.isTabEnabled(port.tab_index(TabName.RECONSTRUCT))
        assert _tab_states(port) == _tab_states(jax)
        for win in (port, jax):
            win.extrinsic_tab.pct_slider.setValue(50)
        assert "drop worst 5.0%" in port.extrinsic_tab.filter_preview.text()
        assert port.extrinsic_tab.filter_preview.text() == jax.extrinsic_tab.filter_preview.text()
        port.close()
        jax.close()

    def test_reopening_restores_calibrated_state(self, app, tmp_path, workspaces, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        workspaces[0].capture_volume.save(pvol)
        workspaces[1].capture_volume.save(jvol)
        port, jax = _windows(tmp_path, workspaces)
        p, j = port.extrinsic_tab, jax.extrinsic_tab
        assert p.presenter is not None and p.presenter.capture_volume is not None
        assert p.presenter.capture_volume.device.type == "cpu"
        assert "RMSE" in p.summary.text() and p.summary.text() == j.summary.text()
        assert p.origin_box.count() == j.origin_box.count() > 0
        assert [p.origin_box.itemText(i) for i in range(p.origin_box.count())] == [
            j.origin_box.itemText(i) for i in range(j.origin_box.count())]
        port.close()
        jax.close()

    def test_origin_operations_update_volume(self, app, tmp_path, workspaces, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        workspaces[0].capture_volume.save(pvol)
        workspaces[1].capture_volume.save(jvol)
        port, jax = _windows(tmp_path, workspaces)
        for win in (port, jax):
            win.extrinsic_tab.center()  # centered() = camera-rig XY centroid to the origin

        def centers(volume):
            return np.stack([-c.rotation.T @ c.translation for _, c in sorted(volume.camera_array.cameras.items()) if c.is_posed])

        got, want = (centers(w.extrinsic_tab.presenter.capture_volume) for w in (port, jax))
        assert np.allclose(got.mean(axis=0)[:2], 0.0, atol=1e-9)
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        port.close()
        jax.close()

    def test_workspace_watcher_triggers_refresh(self, app, tmp_path, workspaces):
        wins = _windows(tmp_path, workspaces)
        calls = []
        for k, (win, ws) in enumerate(zip(wins, workspaces)):
            win.refresh_tabs = lambda k=k: calls.append(k)  # observe post-open refreshes
            win.watcher.poll_once()  # no change -> no event
        app.processEvents()
        assert calls == []
        for win, ws in zip(wins, workspaces):
            ws.settings.save({"version": 3})
            win.watcher.poll_once()
        app.processEvents()
        assert calls == [0, 1]
        for win in wins:
            win.close()


class TestWorkspaceWatcher:
    def test_detects_camera_array_change(self, tmp_path, calibrated_volume):
        pvol, jvol, _ = calibrated_volume
        seen = []
        for W, Watcher, vol, name in ((Workspace, WorkspaceWatcher, pvol, "port"), (JaxWorkspace, JaxWatcher, jvol, "jax")):
            ws = W.create(tmp_path / name)
            events = []
            watcher = Watcher(ws, events.append)
            assert watcher.poll_once() == []
            ws.cameras.save(vol.camera_array)
            seen.append((watcher.poll_once(), events))
        assert seen[0] == seen[1]
        assert "camera_array" in seen[0][0] and seen[0][1] and "camera_array" in seen[0][1][0]

    def test_thread_lifecycle(self, tmp_path):
        seen = []
        for W, Watcher, name in ((Workspace, WorkspaceWatcher, "port"), (JaxWorkspace, JaxWatcher, "jax")):
            ws = W.create(tmp_path / name)
            events = []
            watcher = Watcher(ws, events.append, poll_interval=0.05).start()
            ws.settings.save({"version": 9})
            deadline = time.monotonic() + 5.0
            while not events and time.monotonic() < deadline:
                time.sleep(0.02)
            watcher.stop()
            seen.append(events[:1])
        assert seen[0] == seen[1] and seen[0] and "settings" in seen[0][0]


class TestExplorer:
    """The port's Explorer tab on the JAX tests' gates against the truth."""

    def test_pipeline_recovers_ground_truth(self, app, tmp_path, workspaces):
        from caliscope_tpu_torch.gui.main_window import MainWindow

        win = MainWindow(workspace_dir=workspaces[0].root, settings_path=tmp_path / "s.toml", device="cpu")
        tab = win.explorer_tab
        tab.noise_box.setValue(0.3)
        tab.run_btn.click()
        pump(app, until=lambda: "RMSE" in tab.status.text() or "Error" in tab.status.text(), timeout=600)
        assert "RMSE" in tab.status.text(), tab.status.text()
        result = tab.presenter.result
        assert result.error is None
        assert result.stage_volumes["optimized"].device.type == "cpu"
        assert result.max_rotation_error_deg < 0.5
        assert result.max_translation_error_m < 0.01
        for name, canvas in tab.panels.items():
            assert canvas.pixmap() is not None, name
        assert tab.metrics_table.rowCount() == 4
        img0 = tab.panels["aligned"].pixmap().image.array.copy()
        tab.slider.setValue(tab.slider.maximum())
        img1 = tab.panels["aligned"].pixmap().image.array
        assert (img0 != img1).any()
        win.close()

    def test_perturbed_preset_degrades_extrinsics(self, app):
        from caliscope_tpu_torch.synthetic.explorer import ExplorerPresenter

        clean = ExplorerPresenter(device="cpu")
        clean.select_preset("ring", noise_sigma_px=0.3)
        clean.run_pipeline(block=True)
        perturbed = ExplorerPresenter(device="cpu")
        perturbed.select_preset("perturbed", noise_sigma_px=0.3)
        perturbed.run_pipeline(block=True)
        assert clean.result.error is None and perturbed.result.error is None
        assert perturbed.result.max_translation_error_m > 2 * clean.result.max_translation_error_m


def _cards(tmp_path, url_for):
    """The shipped model cards, their download URL replaced by url_for(name)."""
    from caliscope_tpu_torch.gui.widgets.model_download import CARDS_DIR

    out = tmp_path / "cards"
    out.mkdir()
    for card in sorted(CARDS_DIR.glob("*.toml")):
        text = re.sub(r'(?m)^url = ".*"$', f'url = "{url_for(card.stem)}"', card.read_text())
        (out / card.name).write_text(text)
    return out


class TestModelDialog:
    def test_lists_cards_and_reports_offline_failure(self, app, tmp_path):
        from caliscope_tpu.gui.widgets.model_download import CARDS_DIR as JAX_CARDS_DIR
        from caliscope_tpu_torch.gui.widgets.model_download import CARDS_DIR

        assert sorted(p.read_text() for p in CARDS_DIR.glob("*.toml")) == sorted(
            p.read_text() for p in JAX_CARDS_DIR.glob("*.toml"))
        cards = _cards(tmp_path, lambda name: (tmp_path / "absent" / f"{name}.zip").as_uri())  # no network: a file:// URL
        dlgs = [W.ModelDownloadDialog(models_dir=tmp_path / name, cards_dir=cards) for W, name in ((PW, "p"), (JW, "j"))]
        assert table(dlgs[0].table) == table(dlgs[1].table)
        assert dlgs[0].table.rowCount() == 7  # all shipped RTMPose cards
        assert {dlgs[0].table.item(i, 4).text() for i in range(7)} == {"not downloaded"}
        for dlg in dlgs:
            dlg.table.setCurrentCell(0, 0)
            dlg.download_btn.click()
        pump(app, until=lambda: all("failed" in d.status.text() or "Saved" in d.status.text() for d in dlgs), timeout=120)
        assert all("failed" in d.status.text() and d.download_btn.isEnabled() for d in dlgs)

    def test_existing_model_shows_downloaded(self, app, tmp_path):
        for W, name in ((PW, "p"), (JW, "j")):
            (tmp_path / name).mkdir()
            (tmp_path / name / "rtmpose_t_halpe26.onnx").write_bytes(b"stub")
        dlgs = [W.ModelDownloadDialog(models_dir=tmp_path / name) for W, name in ((PW, "p"), (JW, "j"))]
        by_name = [{d.table.item(i, 0).text(): d.table.item(i, 4).text() for i in range(d.table.rowCount())} for d in dlgs]
        assert by_name[0] == by_name[1]
        assert by_name[0]["RTMPose-t Halpe26"] == "downloaded"


class TestCameraThumbnailCard:
    def test_rotation_persists_and_rotates_thumbnail(self, app, workspaces, tmp_path):
        from caliscope_tpu_torch.media.video import write_gray_video

        frame = np.zeros((64, 96), np.uint8)
        frame[:, :48] = 255  # left half bright: rotation-visible
        cards = []
        for W, ws in zip((PW, JW), workspaces):
            cid = sorted(ws.cameras.load().cameras)[0]
            video = ws.video_path("intrinsic", cid)
            video.parent.mkdir(parents=True, exist_ok=True)
            write_gray_video(video, [frame] * 3)
            card = W.CameraThumbnailCard()
            card.set_camera(ws, cid)
            cards.append((card, ws, cid))
        (pc, pws, cid), (jc, _, _) = cards
        assert pc.rotation_count == jc.rotation_count == 0
        base = pc.thumb_array.copy()
        np.testing.assert_array_equal(base, jc.thumb_array)
        assert base.shape[0] < base.shape[1]  # landscape at rotation 0
        assert base[:, : base.shape[1] // 2].mean() > base[:, base.shape[1] // 2 :].mean()

        for card, _, _ in cards:
            card.cw_btn.click()
        assert pc.rotation_count == jc.rotation_count == 1  # persisted
        assert pws.cameras.load().cameras[cid].rotation_count == 1
        rotated = pc.thumb_array
        np.testing.assert_array_equal(rotated, jc.thumb_array)
        assert rotated.shape[0] > rotated.shape[1]  # portrait after 90 deg
        assert rotated[: rotated.shape[0] // 2].mean() > rotated[rotated.shape[0] // 2 :].mean()

        for card, _, _ in cards:
            card.ccw_btn.click()
        assert pc.rotation_count == jc.rotation_count == 0
        assert pws.cameras.load().cameras[cid].rotation_count == 0

        pc.cw_btn.click()  # a second card sees the persisted value
        card2 = PW.CameraThumbnailCard()
        card2.set_camera(pws, cid)
        assert card2.rotation_count == 1
        assert Path(pws.cameras.path).read_bytes() != b""
