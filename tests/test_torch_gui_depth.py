"""The port's deeper GUI affordances held to the JAX package's, twin by twin
with tests/test_gui_depth.py: the scale-detail dialog, the distance
sparkline, target routing with overflow validation, the workflow detail
rows, the reconstruction view's tracker gating. Both headless backends are
forced and both QApplications reset around each test; the port runs with
device="cpu". Each twin drives both packages' widgets alike and compares
their state exactly and their chart images pixel for pixel. The
Reconstruct tab's run goes through the port's workspace on a short
rendered recording (the JAX package's relay lacks the context-manager
protocol its api enters, so its run fails: ROADMAP.md section 3)."""

import os

os.environ["CALISCOPE_TPU_FORCE_HEADLESS_QT"] = "1"

import time

import numpy as np
import pytest

import caliscope_tpu.gui.qt as JQ
from caliscope_tpu.gui import headless as jax_headless
from caliscope_tpu.scale import FrameScaleError as JaxFrameScaleError
from caliscope_tpu.scale import VolumetricScaleReport as JaxScaleReport
from caliscope_tpu.workspace import Workspace as JaxWorkspace

import caliscope_tpu_torch.gui.qt as PQ
from caliscope_tpu_torch.gui import headless
from caliscope_tpu_torch.scale import FrameScaleError, VolumetricScaleReport
from caliscope_tpu_torch.workspace import Workspace
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class Apps:
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


def _report(Frame=FrameScaleError, Report=VolumetricScaleReport, syncs=(0, 2, 4), mms=(1.0, 3.0, 2.0)):
    frames = tuple(
        Frame(
            sync_index=s, object_id=0, distance_rmse_mm=mm, distance_mean_signed_error_mm=mm / 2,
            distance_max_error_mm=mm * 1.5, n_corners=24, n_distance_pairs=10, n_cameras_contributing=3,
            sum_squared_errors_m2=(mm / 1000.0) ** 2 * 10, sum_squared_relative_errors=0.0, centroid=(0.0, 0.0, 1.0),
        )
        for s, mm in zip(syncs, mms)
    )
    return Report(frame_errors=frames)


def _reports():
    return _report(), _report(JaxFrameScaleError, JaxScaleReport)


def _modules(name):
    import importlib

    return importlib.import_module(f"caliscope_tpu_torch.gui.{name}"), importlib.import_module(f"caliscope_tpu.gui.{name}")


class _Win:
    pass


def _windows(tmp_path, recording=True):
    out = []
    for W, name in ((Workspace, "port"), (JaxWorkspace, "jax")):
        win = _Win()
        win.ws = W.create(tmp_path / name / "proj", **({"device": "cpu"} if W is Workspace else {}))
        if recording:
            (win.ws.root / "recordings" / "take1").mkdir(parents=True)
        out.append(win)
    return out


def _items(box):
    return [box.itemText(i) for i in range(box.count())]


class TestDistanceSparkline:
    def test_data_cursor_and_hover_seek(self, app):
        out = []
        for mod, report in zip(_modules("widgets.distance_sparkline"), _reports()):
            w = mod.DistanceSparkline()
            w.set_data(report, valid_sync_indices=[0, 1, 2, 3, 4])
            seeks = []
            w.cursor_moved.connect(seeks.append)
            state = [w.ymax_label.text(), w.value_at_position(2), w.value_at_position(1), w.position_at_x(0),
                     w.position_at_x(w.W - 1)]
            w.hover(w.W - 1)
            w.set_cursor(4)
            chart = w.chart_array.copy()
            w.clear()
            out.append((state, seeks, chart, w.ymax_label.text()))
        (state, seeks, chart, cleared), (jstate, jseeks, jchart, jcleared) = out
        assert state == jstate and seeks == jseeks == [4] and cleared == jcleared == ""
        np.testing.assert_array_equal(chart, jchart)
        assert "3.0" in state[0] and state[1] == pytest.approx(3.0) and state[2] is None
        assert state[3:] == [0, 4] and chart.shape == (out[0][2].shape[0], out[0][2].shape[1], 3)

    def test_playback_widget_embeds_sparkline(self, app):
        out = []
        for mod, report in zip(_modules("widgets.playback_3d"), _reports()):
            w = mod.Playback3DWidget(width=160, height=120)
            w._sync_indices = np.array([0, 2, 4])
            w.slider.setRange(0, 2)
            w.set_scale_report(report)
            value = w.sparkline.value_at_position(1)
            w.sparkline.hover(w.sparkline.W - 1)  # hover-seek drives the playback slider
            out.append((value, w.slider.value(), w.sparkline.chart_array.copy()))
        assert out[0][:2] == out[1][:2] and out[0][0] == pytest.approx(3.0) and out[0][1] == 2
        np.testing.assert_array_equal(out[0][2], out[1][2])


class TestScaleDetailDialog:
    def test_summary_table_and_click_seek(self, app):
        out = []
        for mod, report in zip(_modules("widgets.scale_detail_dialog"), _reports()):
            d = mod.ScaleDetailDialog()
            d.set_data(report, valid_sync_indices=[0, 2, 4])
            clicks = []
            d.frame_clicked.connect(clicks.append)
            x_last = 44 + d._plot_w() - 1  # right edge of the plot region
            d.click(x_last)
            d.set_cursor(1)
            chart = d.chart_array.copy()
            d.hover(x_last)
            rows = [[d.table.item(i, j).text() for j in range(d.table.columnCount())] for i in range(d.table.rowCount())]
            out.append((d.summary.text(), rows, clicks, d.hover_label.text(), chart))
        *state, chart = out[0]
        *jstate, jchart = out[1]
        assert state == jstate
        np.testing.assert_array_equal(chart, jchart)
        summary, rows, clicks, hover = state
        assert "median" in summary and "bias" in summary
        assert len(rows) == 3 and rows[1][0] == "2" and rows[1][2] == "3.00"
        assert clicks == [4] and "4" in hover

    def test_quality_tabs_open_dialog(self, app):
        out = []
        for mod, report in zip(_modules("widgets.quality_tabs"), _reports()):
            tabs = mod.CalibrationQualityTabs()
            tabs._scale_report = report
            dlg = tabs.open_scale_detail()
            assert dlg is tabs.scale_dialog
            out.append((dlg.table.rowCount(), dlg.summary.text(), dlg.chart_array.copy()))
        assert out[0][:2] == out[1][:2] and out[0][0] == 3
        np.testing.assert_array_equal(out[0][2], out[1][2])


class TestWorkflowStepPanel:
    def test_detail_text_tracks_status(self, app, tmp_path):
        texts = []
        for mod, win in zip(_modules("widgets.step_strip"), _windows(tmp_path, recording=False)):
            panel = mod.WorkflowStepPanel()
            panel.update_status(win.ws.get_workflow_status())
            texts.append({name: panel.detail_text(name) for name in ("Intrinsics", "Extraction", "Extrinsics", "Reconstruction")
                          if name in panel.rows})
        assert texts[0] == texts[1]
        assert "intrinsic videos" in texts[0]["Intrinsics"] and "recordings" in texts[0]["Reconstruction"]


class TestProjectViewRouting:
    def test_routing_roundtrip_and_overflow_revert(self, app, tmp_path):
        out = []
        for mod, win in zip(_modules("views.project_view"), _windows(tmp_path, recording=False)):
            view = mod.ProjectSetupView(win)
            view.refresh()
            view.extrinsic_type.setCurrentText("aruco")
            view.same_as_intrinsic.setChecked(False)
            routing = win.ws.targets.get_routing()
            panel = view.intrinsic_charuco_panel
            panel.dictionary.setCurrentText("DICT_4X4_50")
            panel.rows.setValue(20)
            panel.columns.setValue(20)  # 200 markers cannot fit DICT_4X4_50
            panel._apply()
            out.append(dict(
                routing=(routing.extrinsic, routing.extrinsic_charuco_same_as_intrinsic),
                visible=(view.aruco_panel.isVisible(), view.extrinsic_charuco_panel.isVisible()),
                error=panel.error_label.text(), fields=(panel.rows.value(), panel.columns.value()),
                board=(panel.charuco.rows, panel.charuco.columns),
                files={p.name: p.read_bytes() for p in sorted((win.ws.root / "calibration" / "targets").glob("*"))},
                preview=panel.preview.pixmap().image.array.copy(),
            ))
        p, j = out
        np.testing.assert_array_equal(p.pop("preview"), j.pop("preview"))
        assert p == j
        assert p["routing"] == ("aruco", False) and p["visible"] == (True, False)
        assert p["error"] != "" and p["fields"] == p["board"]  # warned and reverted


class TestReconstructionViewDepth:
    def test_tracker_annotations_and_download_gate(self, app, tmp_path):
        from caliscope_tpu_torch.presenters.processing import ProcessingState

        out = []
        for mod, win in zip(_modules("views.reconstruct_view"), _windows(tmp_path)):
            view = mod.ReconstructionView(win)
            view.refresh()
            items = _items(view.tracker_box)
            state = [view.tracker_box.currentText(), view.selected_tracker_key(), view.selected_tracker_needs_download()]
            onnx = [t for t in items if "(" in t and not t.startswith("target")]
            if onnx:  # cards ship with the package
                view.tracker_box.setCurrentText(onnx[0])
                state.append(view.selected_tracker_needs_download())
                view.run()  # gated: must NOT start, must open the download dialog
                state += [view.state.name, view.status.text()]
            out.append((items, state, view.BUTTON_TEXT[type(view.state).PROCESSING]))
        assert out[0] == out[1]
        items, state, processing = out[0]
        assert state[0].startswith("target (") and state[1] is None and state[2] is False
        assert len(items) == 8 and state[3] is True and state[4] == ProcessingState.IDLE.name and "download" in state[5]
        assert processing == "Processing…"

    def test_open_output_records_path(self, app, tmp_path):
        paths = []
        for mod, win in zip(_modules("views.reconstruct_view"), _windows(tmp_path)):
            view = mod.ReconstructionView(win)
            view.refresh()
            view.rec_box.addItem("take1")
            view.rec_box.setCurrentText("take1")
            view.open_output()
            paths.append(view.last_opened_path.relative_to(win.ws.root))
        assert paths[0] == paths[1] == type(paths[0])("recordings") / "take1"

    def test_run_reconstructs_a_recording(self, app, tmp_path, monkeypatch):
        """The Reconstruct tab's Run on the port, the workspace's target
        tracker on the CPU: the xyz export written, the preview rendered,
        the exports listed. Its points are the JAX package's reconstruction
        of the points the tab extracted, through the saved cameras (1e-9 m),
        and lie on the rendered board's corners (the chip_smoke workspace
        phase's median bound)."""
        import chip_smoke as cs
        from caliscope_tpu.cameras import CameraArray as JaxCameraArray
        from caliscope_tpu.observations import ImagePoints as JaxImagePoints
        from caliscope_tpu.reconstruction import reconstruct_xyz as jax_reconstruct_xyz
        from caliscope_tpu.targets import Charuco as JaxCharuco
        from caliscope_tpu.trackers import CharucoTracker as JaxCharucoTracker

        from caliscope_tpu_torch import api as port_api
        from caliscope_tpu_torch.cameras import CameraArray, CameraData
        from caliscope_tpu_torch.observations import WorldPoints
        from caliscope_tpu_torch.gui.views.reconstruct_view import ReconstructionView
        from caliscope_tpu_torch.media.video import write_gray_video
        from caliscope_tpu_torch.presenters.processing import ProcessingState
        from caliscope_tpu_torch.repositories import TargetRouting

        wh, f = (512, 288), 900.0 * 512 / 640  # tests/test_torch_workspace.py's cut of the recipe
        sq_px = 84 * wh[0] // 640
        win = _Win()
        win.ws = Workspace.create(tmp_path / "proj", device="cpu")
        win.ws.targets.save_intrinsic_charuco(cs.ws_board())
        win.ws.targets.save_routing(TargetRouting(intrinsic="charuco", extrinsic="charuco"))
        cams = {c: v for c, v in cs.ws_cameras(4, wh, f).items() if c in (0, 1)}
        board_img = cs.ws_board().board_image(px_per_square=sq_px, margin_squares=0.5)
        poses = [cs._sweep_pose(np.radians(a), k, 12, 0) for k, a in enumerate((300.0, 325.0))]
        array = {}
        for cid, (K, R, t) in cams.items():
            write_gray_video(win.ws.root / "recordings" / "rec0" / f"cam_{cid}.mp4",
                             [cs.ws_render(board_img, sq_px, (K, R, t), p, wh) for p in poses])
            cam = CameraData(cam_id=cid, size=wh)
            cam.matrix, cam.distortions, cam.rotation, cam.translation = K, np.zeros(5), R, t
            array[cid] = cam
        win.ws.cameras.save(CameraArray(array))
        extracted = []  # the points the tab's run extracted from the recording
        multicam = port_api.extract_image_points_multicam
        monkeypatch.setattr(port_api, "extract_image_points_multicam",
                            lambda *a, **k: extracted.append(multicam(*a, **k)) or extracted[-1])
        view = ReconstructionView(win)
        view.refresh()
        view.rec_box.setCurrentText("rec0")
        view.run()
        deadline = time.monotonic() + 120
        while view.state not in (ProcessingState.COMPLETE, ProcessingState.FAILED) and time.monotonic() < deadline:
            app.processEvents()
            time.sleep(0.01)
        assert view.state == ProcessingState.COMPLETE, view.status.text()
        out = win.ws.root / "recordings" / "rec0" / "CHARUCO"
        assert (out / "xyz_CHARUCO.csv").exists() and (out / "xyz_CHARUCO.trc").exists()
        listed = [view.exports_table.item(i, 0).text() for i in range(view.exports_table.rowCount())]
        assert "CHARUCO/xyz_CHARUCO.csv" in listed
        assert view.preview is not None and "reconstructed frames" in view.stats.text()

        (ip,) = extracted
        assert sorted(set(ip.cam_id.tolist())) == [0, 1]
        jip = JaxImagePoints(*(getattr(ip, c) for c in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc", "frame_time")))
        rows, cols, sq = cs.WS_BOARD
        jax_out = tmp_path / "jax"
        jax_reconstruct_xyz(jip, JaxCameraArray.from_toml(win.ws.cameras.path),
                            JaxCharucoTracker(JaxCharuco(rows=rows, columns=cols, square_size_m=sq)), jax_out)
        got, want = WorldPoints.from_csv(out / "xyz_CHARUCO.csv"), WorldPoints.from_csv(jax_out / "xyz_CHARUCO.csv")
        for c in ("sync_index", "object_id", "keypoint_id"):
            np.testing.assert_array_equal(getattr(got, c), getattr(want, c))
        np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-9)
        assert sorted(set(got.sync_index.tolist())) == [0, 1]
        truth = np.array([cs.ws_board_corners_world(poses[si])[k] for si, k in zip(got.sync_index, got.keypoint_id)])
        assert np.median(np.linalg.norm(got.xyz - truth, axis=1)) < cs.WS_MAX_RECON_MEDIAN_M
