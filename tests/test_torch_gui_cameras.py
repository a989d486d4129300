"""The port's GUI back half held to the JAX package's, twin by twin with
tests/test_gui_cameras.py: the camera list sidebar, the cameras tab, the
theme, the threaded frame rendering and the presenter's display tee, the
playback view model, the frame tools, GC confinement, the link label.

Both packages' headless Qt backends are forced and both QApplication
singletons reset around each test; the port runs with device="cpu". Each
twin drives the same interaction on both packages from the same numpy
inputs and compares widget state exactly and rendered images pixel for
pixel. A test marked `cuda` drives one Cameras-tab calibration on the card
(display queue, render thread and undistortion preview live).
"""

import os
import time

os.environ["CALISCOPE_TPU_FORCE_HEADLESS_QT"] = "1"

import numpy as np
import pytest

import caliscope_tpu.gui.qt as JQ
from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.gui import headless as jax_headless
from caliscope_tpu.gui.theme import Colors as JaxColors
from caliscope_tpu.gui.theme import Styles as JaxStyles
from caliscope_tpu.gui.widgets.camera_list import CameraListWidget as JaxCameraList

import caliscope_tpu_torch.gui.qt as PQ
from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.gui import headless
from caliscope_tpu_torch.gui.qt import Qt
from caliscope_tpu_torch.gui.theme import Colors, Styles, Typography
from caliscope_tpu_torch.gui.widgets.camera_list import CameraListWidget
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


def pump(app, until=None, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        app.processEvents()
        if until is None or until():
            return
        if time.monotonic() > deadline:
            raise TimeoutError("GUI condition not reached")
        time.sleep(0.01)


def _array(calibrated=frozenset(), n=3, Array=CameraArray, Data=CameraData):
    cams = {}
    for cid in range(n):
        cam = Data(cam_id=cid, size=(64, 48))
        if cid in calibrated:
            cam.matrix = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
            cam.distortions = np.zeros(5)
            cam.error = 0.25
        cams[cid] = cam
    return Array(cams)


def _arrays(calibrated=frozenset(), n=3):
    return _array(calibrated, n), _array(calibrated, n, JaxCameraArray, JaxCameraData)


def _rows(lst):
    return [(lst.item(i).text(), lst.item(i).foreground().color().name(), lst.item(i).data(Qt.ItemDataRole.UserRole))
            for i in range(lst.count())]


class _Win:
    pass


def _tab_windows(tmp_path, calibrated=frozenset(), targets=True):
    """A port and a JAX workspace with the same cameras and board, each in a
    stand-in window (the views read win.ws)."""
    from caliscope_tpu.targets import Charuco as JaxCharuco
    from caliscope_tpu.workspace import Workspace as JaxWorkspace
    from caliscope_tpu_torch.targets import Charuco
    from caliscope_tpu_torch.workspace import Workspace

    pw, jw = _Win(), _Win()
    pw.ws = Workspace.create(tmp_path / "port" / "ws", device="cpu")
    jw.ws = JaxWorkspace.create(tmp_path / "jax" / "ws")
    if targets:
        pw.ws.targets.save_intrinsic_charuco(Charuco(rows=4, columns=5, square_size_m=0.05))
        jw.ws.targets.save_intrinsic_charuco(JaxCharuco(rows=4, columns=5, square_size_m=0.05))
        parray, jarray = _arrays(calibrated)
        pw.ws.cameras.save(parray)
        jw.ws.cameras.save(jarray)
    return pw, jw


class TestCameraListWidget:
    def test_rows_show_status_glyphs(self, app):
        parray, jarray = _arrays(calibrated={1})
        lst, jlst = CameraListWidget(parray), JaxCameraList(jarray)
        assert _rows(lst) == _rows(jlst)
        assert lst.count() == 3
        assert lst.item(0).text().startswith("○") and lst.item(1).text().startswith("●")
        assert "0.25px" in lst.item(1).text()
        assert lst.item(1).foreground().color().name() == Colors.SUCCESS == JaxColors.SUCCESS
        assert lst.item(0).foreground().color().name() == Colors.ERROR

    def test_selection_emits_cam_id(self, app):
        got = []
        for lst in (CameraListWidget(_arrays()[0]), JaxCameraList(_arrays()[1])):
            lst.camera_selected.connect(got.append)
            lst.setCurrentRow(2)
        assert got == [2, 2]

    def test_refresh_preserves_selection_without_reemit(self, app):
        out = []
        for lst, refreshed in ((CameraListWidget(_arrays()[0]), _arrays(calibrated={1})[0]),
                               (JaxCameraList(_arrays()[1]), _arrays(calibrated={1})[1])):
            got = []
            lst.camera_selected.connect(got.append)
            lst.setCurrentRow(1)
            lst.refresh(refreshed)
            out.append((got, lst.currentItem().data(Qt.ItemDataRole.UserRole), _rows(lst)))
        assert out[0] == out[1]
        assert out[0][0] == [1] and out[0][1] == 1 and out[0][2][1][0].startswith("●")

    def test_select_cam_id(self, app):
        rows = []
        for lst in (CameraListWidget(_arrays()[0]), JaxCameraList(_arrays()[1])):
            lst.select_cam_id(2)
            rows.append(lst.currentRow())
        assert rows == [2, 2]


class TestTheme:
    def test_styles_are_composed_from_palette(self):
        assert Colors.PRIMARY in Styles.PRIMARY_BUTTON
        assert Colors.PRIMARY_PRESSED in Styles.LIST_SIDEBAR
        assert "disabled" in Styles.PRIMARY_BUTTON
        assert {k: v for k, v in vars(Styles).items() if k.isupper()} == {
            k: v for k, v in vars(JaxStyles).items() if k.isupper()}
        assert {k: v for k, v in vars(Colors).items() if k.isupper()} == {
            k: v for k, v in vars(JaxColors).items() if k.isupper()}


def _render_modules():
    import caliscope_tpu.gui.frame_render as JFR
    import caliscope_tpu_torch.gui.frame_render as PFR

    return PFR, JFR


class TestFrameRenderThread:
    def test_renders_queue_to_pixmaps(self, app):
        images = []
        for FR, Data in zip(_render_modules(), (CameraData, JaxCameraData)):
            q = FR.make_display_queue()
            t = FR.FrameRenderThread(q, Data(cam_id=0, size=(64, 48)), pixmap_edge_length=64)
            got = []
            t.image_ready.connect(got.append)
            t.start()
            frame = np.full((48, 64), 120, np.uint8)
            FR.offer_frame(q, FR.TrackedFrame(frame, np.array([[10.0, 10.0]]), np.array([[5.0, 5.0]])))
            FR.offer_frame(q, None)  # stop sentinel
            pump(app, until=lambda: len(got) >= 1 and not t.isRunning())
            assert t.wait(2000)
            images.append(got[0].array)
        img = images[0]
        np.testing.assert_array_equal(img, images[1])
        assert tuple(img[10, 10]) == (220, 40, 40)
        assert tuple(img[5, 5]) == (40, 170, 170)

    def test_overlay_toggle_rerenders_cached(self, app):
        images = []
        for FR, Data in zip(_render_modules(), (CameraData, JaxCameraData)):
            t = FR.FrameRenderThread(FR.make_display_queue(), Data(cam_id=0, size=(64, 48)), pixmap_edge_length=64)
            got = []
            t.image_ready.connect(got.append)
            t._last = FR.TrackedFrame(np.zeros((48, 64), np.uint8), np.array([[10.0, 10.0]]))
            t.set_overlay_visibility(current_points=False, accumulated=True, selected_grids=True)
            t.rerender_cached()
            images.append(got[-1].array)
        np.testing.assert_array_equal(images[0], images[1])
        assert tuple(images[0][10, 10]) == (0, 0, 0)

    def test_offer_frame_drops_oldest_under_pressure(self):
        kept = []
        for FR in _render_modules():
            q = FR.make_display_queue(maxsize=2)
            for i in range(5):
                FR.offer_frame(q, FR.TrackedFrame(np.full((2, 2), i, np.uint8)))  # never blocks
            kept.append([q.get_nowait().frame[0, 0] for _ in range(2)])
        assert kept[0] == kept[1] == [3, 4]
        assert q.qsize() == 0

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")  # the error ends its thread
    def test_undistortion_preview_and_render_errors(self, app):
        """The preview undistorts on the thread's device (the CPU here) as
        CameraData.undistort_frame does, within one grey level of the JAX
        package's remap; an error on the render thread is kept, emitted and
        ends the thread."""
        PFR, JFR = _render_modules()
        frame = (np.arange(48 * 64, dtype=np.int64).reshape(48, 64) * 7 % 251).astype(np.uint8)
        images = []
        for FR, Data, kw in ((PFR, CameraData, {"device": "cpu"}), (JFR, JaxCameraData, {})):
            cam = _array({0}, 1, Array=dict, Data=Data)[0]
            cam.distortions = np.array([-0.2, 0.05, 0.0, 0.0, 0.0])
            t = FR.FrameRenderThread(FR.make_display_queue(), None, pixmap_edge_length=64, **kw)
            t.set_undistort(True, cam)
            got = []
            t.image_ready.connect(got.append)
            t._last = FR.TrackedFrame(frame)
            t.rerender_cached()
            images.append(got[-1].array.astype(np.int16))
        assert (images[0] != np.repeat(frame[:, :, None], 3, axis=2)).any()
        assert np.abs(images[0] - images[1]).max() <= 1

        q = PFR.make_display_queue()
        broken = CameraData(cam_id=0, size=(64, 48))
        broken.matrix = np.eye(3)  # intrinsics without distortions: undistort_frame raises
        t = PFR.FrameRenderThread(q, broken, pixmap_edge_length=64, device="cpu")
        t.set_undistort(True)
        errors = []
        t.error_occurred.connect(errors.append)
        t.start()
        PFR.offer_frame(q, PFR.TrackedFrame(frame))
        pump(app, until=lambda: errors and not t.isRunning())
        assert t.error is not None and errors and type(t.error).__name__ in errors[0]
        assert t.frames_rendered == 0


class TestDisplayTee:
    def test_presenter_tee_feeds_queue_during_extraction(self, app):
        import torch

        from caliscope_tpu.gui.frame_render import make_display_queue as jax_queue
        from caliscope_tpu.packets import PixelFormat as JaxPixelFormat
        from caliscope_tpu.packets import PointPacket as JaxPointPacket
        from caliscope_tpu.presenters.intrinsic import _DisplayTeeTracker as JaxTee
        from caliscope_tpu.tracker import Tracker as JaxTracker
        from caliscope_tpu_torch.gui.frame_render import make_display_queue
        from caliscope_tpu_torch.packets import PixelFormat, PointPacket
        from caliscope_tpu_torch.presenters.intrinsic import _DisplayTeeTracker
        from caliscope_tpu_torch.tracker import Tracker

        def fake(Base, Packet, Format, loc):
            class FakeTracker(Base):
                @property
                def name(self):
                    return "FAKE"

                @property
                def pixel_format(self):
                    return Format.GRAY

                def _detect(self, frame, cam_id=0, rotation_count=0):
                    return Packet(object_id=np.zeros(1), keypoint_id=np.zeros(1), img_loc=loc(), obj_loc=np.zeros((1, 3)))

                def get_point_name(self, keypoint_id):
                    return "p"

            return FakeTracker()

        frames = (np.arange(3 * 8 * 8) % 256).astype(np.uint8).reshape(3, 8, 8)
        runs = []
        for Tee, Q, tracker, batch in (
            (_DisplayTeeTracker, make_display_queue, fake(Tracker, PointPacket, PixelFormat, lambda: np.array([[3.0, 4.0]])), frames),
            # a device tracker's tensors reach the queue as host numpy arrays
            (_DisplayTeeTracker, make_display_queue, fake(Tracker, PointPacket, PixelFormat, lambda: torch.tensor([[3.0, 4.0]])),
             torch.from_numpy(frames)),
            (JaxTee, jax_queue, fake(JaxTracker, JaxPointPacket, JaxPixelFormat, lambda: np.array([[3.0, 4.0]])), frames),
        ):
            q = Q()
            tee = Tee(tracker, q)
            pkts = tee.get_points_batch(batch)
            assert len(pkts) == 3 and all(len(p) == 1 for p in pkts)
            items = [q.get_nowait() for _ in range(3)]
            assert all(isinstance(it.frame, np.ndarray) and isinstance(it.current_xy, np.ndarray) for it in items)
            runs.append([(it.frame.tolist(), it.current_xy.tolist(), it.accumulated_xy.tolist()) for it in items])
        assert runs[0] == runs[1] == runs[2]
        assert [len(acc) for _, _, acc in runs[0]] == [1, 2, 3]  # accumulated coverage grows


def _world_points(WP, static):
    sync = np.array([0, 0, 2, static])
    obj = np.array([0, 0, 0, 1])
    kp = np.array([7, 9, 7, 0])
    xyz = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]], float)
    return WP(sync, obj, kp, xyz)


def _vms(wireframes=(None, None)):
    from caliscope_tpu.gui.view_models import PlaybackViewModel as JaxVM
    from caliscope_tpu.observations import STATIC_SYNC_INDEX as JS
    from caliscope_tpu.observations import WorldPoints as JaxWP
    from caliscope_tpu_torch.gui.view_models import PlaybackViewModel
    from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, WorldPoints

    parray, jarray = _arrays(calibrated={0})
    return (PlaybackViewModel(parray, _world_points(WorldPoints, STATIC_SYNC_INDEX), wireframes[0]),
            JaxVM(jarray, _world_points(JaxWP, JS), wireframes[1]))


class TestPlaybackViewModel:
    def test_canonical_map_and_fixed_buffers(self):
        vm, jvm = _vms()
        assert vm.n_points == jvm.n_points == 3
        assert vm.id_to_index == jvm.id_to_index
        for sync in (0, 2):
            np.testing.assert_array_equal(vm.get_frame_geometry(sync).points, jvm.get_frame_geometry(sync).points)
        geo0, geo2 = vm.get_frame_geometry(0), vm.get_frame_geometry(2)
        assert geo0.points.shape == (3, 3)
        assert np.allclose(geo0.points[vm.id_to_index[(0, 7)]], [0, 0, 0])
        assert np.allclose(geo0.points[vm.id_to_index[(0, 9)]], [1, 0, 0])
        assert np.allclose(geo2.points[vm.id_to_index[(0, 7)]], [0, 1, 0])
        assert np.isnan(geo2.points[vm.id_to_index[(0, 9)]]).all()

    def test_static_points_composited_into_every_frame(self):
        vm, jvm = _vms()
        for sync in (0, 2):
            got = vm.get_frame_geometry(sync).points[vm.id_to_index[(1, 0)]]
            np.testing.assert_array_equal(got, jvm.get_frame_geometry(sync).points[jvm.id_to_index[(1, 0)]])
            assert np.allclose(got, [5, 5, 5])

    def test_valid_sync_indices_skip_static_and_empty(self):
        vm, jvm = _vms()
        assert vm.valid_sync_indices.tolist() == jvm.valid_sync_indices.tolist() == [0, 2]
        assert (vm.min_index, vm.max_index) == (jvm.min_index, jvm.max_index) == (0, 2)

    def test_wireframe_topology_resolved_to_buffer_indices(self):
        from caliscope_tpu.tracker import Segment as JaxSegment
        from caliscope_tpu.tracker import WireFrameView as JaxWireFrame
        from caliscope_tpu_torch.tracker import Segment, WireFrameView

        vm, jvm = _vms((
            WireFrameView(segments=(Segment(name="a", color="g", point_A="A", point_B="B"),), point_names={"A": 7, "B": 9}),
            JaxWireFrame(segments=(JaxSegment(name="a", color="g", point_A="A", point_B="B"),), point_names={"A": 7, "B": 9}),
        ))
        (lines, colors), (jlines, jcolors) = vm.get_static_wireframe_data(), jvm.get_static_wireframe_data()
        np.testing.assert_array_equal(lines, jlines)
        np.testing.assert_array_equal(colors, jcolors)
        assert lines.shape == (1, 2) and colors.shape == (1, 3)
        assert {int(lines[0, 0]), int(lines[0, 1])} == {vm.id_to_index[(0, 7)], vm.id_to_index[(0, 9)]}

    def test_camera_only_mode(self):
        from caliscope_tpu.gui.view_models import PlaybackViewModel as JaxVM
        from caliscope_tpu_torch.gui.view_models import PlaybackViewModel

        parray, jarray = _arrays(calibrated={0})
        vm, jvm = PlaybackViewModel.from_camera_array_only(parray), JaxVM.from_camera_array_only(jarray)
        assert not vm.has_points and not jvm.has_points
        assert vm.get_frame_geometry(0).points.shape == jvm.get_frame_geometry(0).points.shape == (0, 3)

    def test_playback_widget_renders_view_model(self, app):
        from caliscope_tpu.gui.widgets import Playback3DWidget as JaxPlayback
        from caliscope_tpu.synthetic.factories import default_ring_scene as jax_ring_scene
        from caliscope_tpu_torch.gui.widgets import Playback3DWidget
        from caliscope_tpu_torch.synthetic.factories import default_ring_scene

        images, syncs = [], []
        for W, vm, scene in zip((Playback3DWidget, JaxPlayback), _vms(), (default_ring_scene(n_frames=4), jax_ring_scene(n_frames=4))):
            vm.camera_array = scene.cameras
            w = W(width=160, height=120)
            w.set_view_model(vm)
            images.append(w.canvas.pixmap().image.array.copy())
            w.slider.setValue(1)  # scrub to the second valid sync index
            syncs.append(w.current_sync_index())
            images.append(w.canvas.pixmap().image.array)
        np.testing.assert_array_equal(images[0], images[2])
        np.testing.assert_array_equal(images[1], images[3])
        assert syncs == [2, 2]


class TestCamerasTab:
    def test_tab_pools_panels_and_previews_pattern(self, app, tmp_path):
        from caliscope_tpu.gui.views import CamerasTabWidget as JaxTab
        from caliscope_tpu_torch.gui.views import CamerasTabWidget

        tabs = [W(win) for W, win in zip((CamerasTabWidget, JaxTab), _tab_windows(tmp_path, calibrated={0}))]
        panels0 = []
        for tab in tabs:
            assert tab._current_cam_id == 0 and set(tab._panels) == {0}
            panels0.append(tab._panels[0])
            tab.camera_list.select_cam_id(1)
            assert tab._current_cam_id == 1 and set(tab._panels) == {0, 1}
        assert all(tab._panels[0] is p for tab, p in zip(tabs, panels0))  # pooled, not recreated
        p, j = tabs
        np.testing.assert_array_equal(p.pattern_preview.pixmap().image.array, j.pattern_preview.pixmap().image.array)
        assert "5 x 4" in p.pattern_info.text() and p.pattern_info.text() == j.pattern_info.text()
        assert p._panels[0].status_label.text() == j._panels[0].status_label.text()
        np.testing.assert_array_equal(p._panels[0].lens.canvas.pixmap().image.array,
                                      j._panels[0].lens.canvas.pixmap().image.array)
        for tab in tabs:
            tab.frame_skip_spin.setValue(7)
        assert p.frame_skip == j.frame_skip == 7
        for tab in tabs:
            tab.cleanup()

    def test_calibration_complete_updates_sidebar(self, app, tmp_path):
        from caliscope_tpu.gui.views import CamerasTabWidget as JaxTab
        from caliscope_tpu.pipelines.calibrate_intrinsics import IntrinsicCalibrationOutput as JaxOutput
        from caliscope_tpu.pipelines.calibrate_intrinsics import IntrinsicCalibrationReport as JaxReport
        from caliscope_tpu_torch.gui.views import CamerasTabWidget
        from caliscope_tpu_torch.pipelines.calibrate_intrinsics import (
            IntrinsicCalibrationOutput,
            IntrinsicCalibrationReport,
        )

        wins = _tab_windows(tmp_path)
        tabs = [W(win) for W, win in zip((CamerasTabWidget, JaxTab), wins)]
        assert tabs[0].camera_list.item(1).text().startswith("○")
        report = dict(rmse=0.3, frames_used=10, coverage_fraction=0.8, edge_coverage_fraction=0.5,
                      corner_coverage_fraction=0.5, orientation_sufficient=True, orientation_count=4,
                      selected_frames=(0, 1, 2))
        for tab, Output, Report, arrays in ((tabs[0], IntrinsicCalibrationOutput, IntrinsicCalibrationReport, 0),
                                            (tabs[1], JaxOutput, JaxReport, 1)):
            cam = _arrays(calibrated={1})[arrays].cameras[1]
            tab.on_calibration_complete(1, Output(camera=cam, report=Report(**report)))
        assert _rows(tabs[0].camera_list) == _rows(tabs[1].camera_list)
        assert tabs[0].camera_list.item(1).text().startswith("●")
        assert wins[0].ws.cameras.load().cameras[1].matrix is not None
        assert wins[0].ws.cameras.path.read_bytes() == wins[1].ws.cameras.path.read_bytes()
        for tab in tabs:
            tab.cleanup()

    def test_render_error_stays_shown_after_calibrate(self, app, tmp_path):
        """A Calibrate whose undistortion preview fails on the render thread:
        the calibration completes and its result is shown, and the display
        error stays on the panel beside it."""
        from torch_targets_common import posed_board_views

        from caliscope_tpu_torch.gui.views import CamerasTabWidget
        from caliscope_tpu_torch.media.video import write_gray_video
        from caliscope_tpu_torch.targets import Charuco
        from caliscope_tpu_torch.workspace import Workspace

        board = Charuco(rows=5, columns=7, square_size_m=0.054)
        win = _Win()
        win.ws = Workspace.create(tmp_path / "ws", device="cpu")
        win.ws.targets.save_intrinsic_charuco(board)
        K = np.array([[450.0, 0, 320], [0, 450.0, 180], [0, 0, 1]])
        frames, _ = posed_board_views(board, 50, K, (640, 360), 8, seed=5)
        write_gray_video(win.ws.video_path("intrinsic", 0), frames)
        tab = CamerasTabWidget(win)
        tab.frame_skip_spin.setValue(1)
        panel = tab._panels[0]
        panel.run_btn.click()
        presenter, thread = panel.presenter, panel.render_thread
        broken = CameraData(cam_id=0, size=(640, 360))
        broken.matrix = K  # intrinsics without distortions: undistort_frame raises
        thread.set_undistort(True, broken)
        pump(app, until=lambda: panel.presenter is None, timeout=120)
        assert presenter.output is not None
        assert thread.error is not None and thread.frames_rendered == 0
        text = panel.status_label.text()
        assert text.startswith("fx=") and f"Display error: {type(thread.error).__name__}" in text, text
        assert panel.render_error is not None and panel.status_label._style == Typography.STATUS_ERROR  # the headless label keeps its style sheet
        tab.cleanup()

    @pytest.mark.cuda
    def test_calibrate_on_the_card(self, app, tmp_path):
        """One Cameras-tab calibration on the card: the tracker and the solve
        on CUDA, the display queue and the render thread live with the
        undistortion preview on, frames displayed and no render error."""
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        from torch_targets_common import posed_board_views

        from caliscope_tpu_torch.gui.views import CamerasTabWidget
        from caliscope_tpu_torch.media.video import write_gray_video
        from caliscope_tpu_torch.targets import Charuco
        from caliscope_tpu_torch.workspace import Workspace

        board = Charuco(rows=5, columns=7, square_size_m=0.054)
        win = _Win()
        win.ws = Workspace.create(tmp_path / "ws", device="cuda")
        win.ws.targets.save_intrinsic_charuco(board)
        K = np.array([[900.0, 0, 640], [0, 900.0, 360], [0, 0, 1]])
        frames, _ = posed_board_views(board, 100, K, (1280, 720), 12, seed=5)
        write_gray_video(win.ws.video_path("intrinsic", 0), frames)
        tab = CamerasTabWidget(win)
        tab.frame_skip_spin.setValue(1)
        panel = tab._panels[0]
        panel.run_btn.click()
        presenter, thread = panel.presenter, panel.render_thread
        assert presenter is not None and presenter.device == "cuda"
        seeded = CameraData(cam_id=0, size=frames[0].shape[::-1])
        seeded.matrix = np.array([[700.0, 0, frames[0].shape[1] / 2], [0, 700.0, frames[0].shape[0] / 2], [0, 0, 1]])
        seeded.distortions = np.array([-0.1, 0.0, 0.0, 0.0, 0.0])
        thread.set_undistort(True, seeded)
        pump(app, until=lambda: panel.presenter is None, timeout=300)
        assert presenter.output is not None, panel.status_label.text()
        assert presenter.output.report.rmse < 1.0
        assert thread.error is None and thread.frames_rendered >= 1
        assert panel.video_label.pixmap() is not None
        tab.cleanup()


class TestFrameTools:
    def test_resize_to_square_and_rotation(self):
        from caliscope_tpu.gui import frame_tools as JFT
        from caliscope_tpu_torch.gui import frame_tools as PFT

        frame = np.arange(6, dtype=np.uint8).reshape(2, 3)
        for FT in (PFT, JFT):
            sq = FT.resize_to_square(frame)
            assert sq.shape == (3, 3) and sq[0].tolist() == [0, 1, 2]
        np.testing.assert_array_equal(PFT.resize_to_square(frame), JFT.resize_to_square(frame))
        for k in (-1, 0, 1, 2, 3, 4):
            np.testing.assert_array_equal(PFT.apply_rotation(frame, k), JFT.apply_rotation(frame, k))
        r1 = PFT.apply_rotation(frame, 1)  # clockwise
        assert r1.shape == (3, 2) and r1[0].tolist() == [3, 0]
        np.testing.assert_array_equal(PFT.apply_rotation(frame, -1), PFT.apply_rotation(frame, 3))
        np.testing.assert_array_equal(PFT.apply_rotation(frame, 4), frame)
        img, jimg = PFT.frame_to_qimage(frame), JFT.frame_to_qimage(frame)
        assert (img.width(), img.height()) == (jimg.width(), jimg.height()) == (3, 2)
        np.testing.assert_array_equal(img.array, jimg.array)


class TestGcConfinement:
    def test_confines_and_restores(self, app):
        import gc

        from caliscope_tpu.gui import gc_confinement as JGC
        from caliscope_tpu_torch.gui import gc_confinement as PGC

        for GC in (PGC, JGC):
            assert gc.isenabled()
            timer = GC.enable(interval_ms=50)
            try:
                assert not gc.isenabled()
                assert timer.isActive()
            finally:
                GC.disable(timer)
            assert gc.isenabled()
            assert not timer.isActive()


class TestLinkLabelAndPlaceholder:
    def test_link_label_styles_and_clicks(self, app):
        from caliscope_tpu.gui.widgets import LinkLabel as JaxLinkLabel
        from caliscope_tpu_torch.gui.widgets import LinkLabel

        out = []
        for W in (LinkLabel, JaxLinkLabel):
            lbl = W("docs")
            styles = [lbl._style]
            lbl.set_hovered(True)
            styles.append(lbl._style)
            got = []
            lbl.clicked.connect(lambda got=got: got.append(1))
            lbl.click()
            out.append((styles, got))
        assert out[0] == out[1]
        (plain, hovered), got = out[0]
        assert Colors.PRIMARY in plain and "text-decoration: none" in plain
        assert "text-decoration: underline" in hovered and got == [1]

    def test_cameras_tab_shows_placeholder_without_videos(self, app, tmp_path):
        from caliscope_tpu.gui.views import CamerasTabWidget as JaxTab
        from caliscope_tpu_torch.gui.views import CamerasTabWidget

        tabs = [W(win) for W, win in zip((CamerasTabWidget, JaxTab), _tab_windows(tmp_path, targets=False))]
        for tab in tabs:
            assert tab.camera_list.count() == 0
        assert "No intrinsic calibration videos" in tabs[0].placeholder.label.text()
        assert tabs[0].placeholder.label.text() == tabs[1].placeholder.label.text()
        for tab in tabs:
            tab.cleanup()
