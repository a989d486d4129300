"""The port's repositories (caliscope_tpu_torch/repositories.py) against the
JAX package's: every file either writes for equal objects is the other's
byte for byte (camera_array.toml, the capture-volume folder with its CSVs
and constraints.toml, targets with routing, project_settings.toml,
intrinsic reports), each package loads the other's files into equal
objects, and the failure modes raise the same way. The capture volume's
CSVs are compared exactly where the port reads them, and within the last
digits where the JAX package reads them through pandas, whose float parser
is not correctly rounded (ROADMAP.md section 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from caliscope_tpu import repositories as JR
from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.constraints import ConstraintSet as JaxConstraintSet
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.observations import WorldPoints as JaxWorldPoints
from caliscope_tpu.pipelines.calibrate_intrinsics import IntrinsicCalibrationReport as JaxReport
from caliscope_tpu.targets import ArucoMarker as JaxArucoMarker
from caliscope_tpu.targets import ArucoMarkerSet as JaxArucoMarkerSet
from caliscope_tpu.targets import Charuco as JaxCharuco
from caliscope_tpu.targets import Chessboard as JaxChessboard
from caliscope_tpu.volume import CaptureVolume as JaxCaptureVolume

from caliscope_tpu_torch import repositories as TR
from caliscope_tpu_torch.constraints import ConstraintSet
from caliscope_tpu_torch.pipelines.calibrate_intrinsics import IntrinsicCalibrationReport
from caliscope_tpu_torch.synthetic.factories import default_ring_scene
from caliscope_tpu_torch.targets import ArucoMarker, ArucoMarkerSet, Charuco, Chessboard
from caliscope_tpu_torch.volume import CaptureVolume
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMG_COLS = ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc", "frame_time")
WORLD_COLS = ("sync_index", "object_id", "keypoint_id", "xyz", "frame_time")


def _to_jax_array(cams):
    return JaxCameraArray({cid: JaxCameraData(**dataclasses.asdict(c)) for cid, c in cams.cameras.items()})


@pytest.fixture(scope="module")
def scene():
    s = default_ring_scene(3, 4)
    ip, wp = s.image_points_noisy(), s.world_points()
    jip = JaxImagePoints(*(getattr(ip, c) for c in IMG_COLS))
    jwp = JaxWorldPoints(*(getattr(wp, c) for c in WORLD_COLS))
    board = Charuco(rows=5, columns=7, square_size_m=0.054)
    return s.cameras, ip, wp, _to_jax_array(s.cameras), jip, jwp, board


def _same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _assert_cameras_equal(got, want):
    """Every field equal; the rotation, stored as a Rodrigues vector, to
    1e-15 (each package's exponential map rounds on its own)."""
    assert sorted(got.cameras) == sorted(want.cameras)
    for cid in want.cameras:
        g, w = dataclasses.asdict(got.cameras[cid]), dataclasses.asdict(want.cameras[cid])
        for k in w:
            assert (g[k] is None) == (w[k] is None), (cid, k)
            if k == "rotation" and w[k] is not None:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-15, err_msg=f"{cid} {k}")
            elif w[k] is not None:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=f"{cid} {k}")


def test_camera_array_files_and_cross_loading(tmp_path, scene):
    cams, *_ , jcams, _, _, _ = scene
    port, jax = TR.CameraArrayRepository(tmp_path / "p.toml"), JR.CameraArrayRepository(tmp_path / "j.toml")
    assert not port.exists()
    port.save(cams)
    jax.save(jcams)
    assert port.path.read_bytes() == jax.path.read_bytes()
    _assert_cameras_equal(TR.CameraArrayRepository(jax.path).load(), JR.CameraArrayRepository(port.path).load())
    _assert_cameras_equal(TR.CameraArrayRepository(jax.path).load(), cams)
    one = dataclasses.replace(cams.cameras[1], error=0.25)
    port.save_camera(one)
    jax.save_camera(JaxCameraData(**dataclasses.asdict(one)))
    assert port.path.read_bytes() == jax.path.read_bytes()
    fresh = TR.CameraArrayRepository(tmp_path / "new" / "p.toml")
    fresh.save_camera(one)
    jfresh = JR.CameraArrayRepository(tmp_path / "new" / "j.toml")
    jfresh.save_camera(JaxCameraData(**dataclasses.asdict(one)))
    assert fresh.path.read_bytes() == jfresh.path.read_bytes()


@pytest.mark.parametrize("constrained", [False, True])
def test_capture_volume_files_and_cross_loading(tmp_path, scene, constrained):
    cams, ip, wp, jcams, jip, jwp, board = scene
    cs = ConstraintSet.from_charuco(board) if constrained else None
    jcs = JaxConstraintSet.from_charuco(JaxCharuco(rows=5, columns=7, square_size_m=0.054)) if constrained else None
    port = TR.CaptureVolumeRepository(tmp_path / "port")
    jax = JR.CaptureVolumeRepository(tmp_path / "jax")
    assert not port.exists()
    port.save(CaptureVolume(cams, ip, wp, cs, device="cpu"))
    jax.save(JaxCaptureVolume(jcams, jip, jwp, jcs))
    names = ["camera_array.toml", "image_points.csv", "world_points.csv"] + (["constraints.toml"] if constrained else [])
    assert sorted(p.name for p in port.base_path.iterdir()) == sorted(p.name for p in jax.base_path.iterdir()) == sorted(names)
    _same_files(port.base_path, jax.base_path, names)
    got = TR.CaptureVolumeRepository(jax.base_path).load(device="cpu")
    assert got.device.type == "cpu"
    _assert_cameras_equal(got.camera_array, cams)
    want = JR.CaptureVolumeRepository(port.base_path).load()
    for cols, g, w, ref in ((IMG_COLS, got.image_points, want.image_points, ip), (WORLD_COLS, got.world_points, want.world_points, wp)):
        for c in cols:
            assert (getattr(g, c) is None) == (getattr(w, c) is None) == (getattr(ref, c) is None), c
            if getattr(ref, c) is not None:
                np.testing.assert_array_equal(getattr(g, c), getattr(ref, c))
                np.testing.assert_allclose(getattr(w, c), getattr(ref, c), rtol=2e-15, atol=1e-16)
    assert (got.constraints is None) == (want.constraints is None) == (not constrained)
    if constrained:
        assert got.constraints == cs
        assert [dataclasses.astuple(d) for d in want.constraints.distances] == [dataclasses.astuple(d) for d in cs.distances]


def test_capture_volume_load_errors(tmp_path):
    for repo in (TR.CaptureVolumeRepository(tmp_path / "none"), JR.CaptureVolumeRepository(tmp_path / "none")):
        assert not repo.exists()
        with pytest.raises(ValueError, match="Failed to load capture volume"):
            repo.load()


def test_camera_array_load_errors(tmp_path):
    bad = tmp_path / "camera_array.toml"
    bad.write_text("[cameras\nbroken = ")
    for repo in (TR.CameraArrayRepository(bad), JR.CameraArrayRepository(bad)):
        with pytest.raises(ValueError, match="Failed to load camera array"):
            repo.load()


def _targets(pkg):
    if pkg == "port":
        return (Charuco(rows=6, columns=8, square_size_m=0.04, thickness_m=0.003),
                Chessboard(6, 9, 0.025),
                ArucoMarkerSet("DICT_4X4_50", {3: ArucoMarker(3, 0.1), 7: ArucoMarker(7, 0.08)}))
    return (JaxCharuco(rows=6, columns=8, square_size_m=0.04, thickness_m=0.003),
            JaxChessboard(6, 9, 0.025),
            JaxArucoMarkerSet("DICT_4X4_50", {3: JaxArucoMarker(3, 0.1), 7: JaxArucoMarker(7, 0.08)}))


def test_targets_and_routing_files(tmp_path):
    port = TR.CalibrationTargetsRepository(tmp_path / "port" / "targets", legacy_root=tmp_path / "port")
    jax = JR.CalibrationTargetsRepository(tmp_path / "jax" / "targets", legacy_root=tmp_path / "jax")
    assert port.get_routing() == TR.TargetRouting() and not port.intrinsic_charuco_exists()
    port.initialize_defaults()
    jax.initialize_defaults()
    _same_files(port.targets_dir, jax.targets_dir, ["config.toml", "intrinsic_charuco.toml"])
    for repo, (ch, cb, ms), routing in (
        (port, _targets("port"), TR.TargetRouting("chessboard", "aruco", False)),
        (jax, _targets("jax"), JR.TargetRouting("chessboard", "aruco", False)),
    ):
        repo.save_routing(routing)
        repo.save_intrinsic_charuco(ch)
        repo.save_extrinsic_charuco(ch)
        repo.save_chessboard(cb)
        repo.save_aruco_marker_set(ms)
    names = ["config.toml", "intrinsic_charuco.toml", "extrinsic_charuco.toml", "chessboard.toml", "aruco_marker_set.toml"]
    assert sorted(p.name for p in port.targets_dir.iterdir()) == sorted(names)
    _same_files(port.targets_dir, jax.targets_dir, names)
    cross = TR.CalibrationTargetsRepository(jax.targets_dir)
    jcross = JR.CalibrationTargetsRepository(port.targets_dir)
    assert dataclasses.asdict(cross.get_routing()) == dataclasses.asdict(jcross.get_routing())
    assert cross.get_extrinsic_tracker_name() == jcross.get_extrinsic_tracker_name() == "ARUCO"
    assert dataclasses.asdict(cross.load_extrinsic_charuco()) == dataclasses.asdict(jcross.load_extrinsic_charuco())
    assert dataclasses.asdict(cross.load_chessboard()) == dataclasses.asdict(jcross.load_chessboard())
    assert sorted(cross.load_aruco_marker_set().markers) == sorted(jcross.load_aruco_marker_set().markers) == [3, 7]
    assert cross.chessboard_exists() and cross.aruco_marker_set_exists()


def test_legacy_root_charuco(tmp_path):
    Charuco(rows=4, columns=6, square_size_m=0.03).to_toml(tmp_path / "charuco.toml")
    port = TR.CalibrationTargetsRepository(tmp_path / "calibration" / "targets", legacy_root=tmp_path)
    jax = JR.CalibrationTargetsRepository(tmp_path / "calibration" / "targets", legacy_root=tmp_path)
    assert port.intrinsic_charuco_exists() and jax.intrinsic_charuco_exists()
    assert dataclasses.asdict(port.load_intrinsic_charuco()) == dataclasses.asdict(jax.load_intrinsic_charuco())
    assert port.load_extrinsic_charuco().columns == 6


def test_project_settings_files(tmp_path):
    port = TR.ProjectSettingsRepository(tmp_path / "p.toml")
    jax = JR.ProjectSettingsRepository(tmp_path / "j.toml")
    settings = {"version": 1, "fps": 29.97, "name": "rig \"A\"", "skip": None, "flags": [1, 2, 3]}
    port.save(settings)
    jax.save(settings)
    assert port.path.read_bytes() == jax.path.read_bytes()
    port.set("frame_step", 5)
    jax.set("frame_step", 5)
    assert port.path.read_bytes() == jax.path.read_bytes()
    assert TR.ProjectSettingsRepository(jax.path).all == JR.ProjectSettingsRepository(port.path).all
    assert port.get("missing", 7) == 7 and port.get("fps") == 29.97
    (tmp_path / "bad.toml").write_text("version = ")
    for cls in (TR.ProjectSettingsRepository, JR.ProjectSettingsRepository):
        with pytest.raises(ValueError, match="Failed to load project settings"):
            cls(tmp_path / "bad.toml")


def test_intrinsic_report_files(tmp_path):
    fields = dict(rmse=0.4123, frames_used=27, coverage_fraction=0.875, edge_coverage_fraction=0.5,
                  corner_coverage_fraction=0.25, orientation_sufficient=True, orientation_count=7,
                  selected_frames=(0, 5, 10, 40))
    port, jax = TR.IntrinsicReportRepository(tmp_path / "p"), JR.IntrinsicReportRepository(tmp_path / "j")
    for cid in (0, 3):
        port.save(cid, IntrinsicCalibrationReport(**fields))
        jax.save(cid, JaxReport(**fields))
        assert (port.reports_dir / f"cam_{cid}.toml").read_bytes() == (jax.reports_dir / f"cam_{cid}.toml").read_bytes()
    (port.reports_dir / "cam_x.toml").write_text("junk = 1")
    (jax.reports_dir / "cam_x.toml").write_text("junk = 1")
    got, want = TR.IntrinsicReportRepository(jax.reports_dir).load_all(), JR.IntrinsicReportRepository(port.reports_dir).load_all()
    assert sorted(got) == sorted(want) == [0, 3]
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3]) == fields
    (port.reports_dir / "cam_9.toml").write_text("rmse = 1.0")
    assert port.load(9) is None and port.load(4) is None
    assert port.delete(3) and not port.delete(3)
