"""The other two targets: the port's ArucoTracker and ChessboardTracker
(caliscope_tpu_torch.trackers) held against the JAX package's on the same
frames drawn in numpy (tests/torch_targets_common.py), both on the CPU in
float32; the targets' TOML round trips; ConstraintSet.from_marker_set /
from_chessboard on the real targets.

Tolerances. Ids, keypoint ids and obj_loc are equal. Chessboard corners
agree within 1.5e-4 px: both pipelines compute them in float32 and sum in
other orders, and at these coordinates (< 512 px) one float32 ulp is
3.05e-5 px, so the 2e-5 px of the ChArUco slice is below one ulp here;
observed 3.05e-5 (one ulp). ArUco corners come from edge-line fits, which
part by ~2e-3 px between the two packages, so they are held to the marker
stage's own 0.02 px (tests/test_torch_aruco.py).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from caliscope_tpu.constraints import ConstraintSet as JCS
from caliscope_tpu.targets import ArucoMarker as JArucoMarker
from caliscope_tpu.targets import ArucoMarkerSet as JArucoMarkerSet
from caliscope_tpu.targets import Chessboard as JChessboard
from caliscope_tpu.targets import DistanceLink as JDistanceLink
from caliscope_tpu.targets import MirrorPair as JMirrorPair
from caliscope_tpu.trackers import ArucoTracker as JArucoTracker
from caliscope_tpu.trackers import ChessboardTracker as JChessboardTracker
from caliscope_tpu.trackers.wireframe_builder import build_wireframe as j_build_wireframe

import caliscope_tpu_torch.detect.ccl as TC
import caliscope_tpu_torch.detect.cuda_kernels as CK
from caliscope_tpu_torch import ConstraintSet, convert
from caliscope_tpu_torch.packets import PixelFormat
from caliscope_tpu_torch.targets import ArucoMarker, ArucoMarkerSet, Chessboard
from caliscope_tpu_torch.targets import render
from caliscope_tpu_torch.trackers import ArucoTracker, ChessboardTracker
from caliscope_tpu_torch.trackers.wireframe_builder import build_wireframe
from test_torch_constraints import MARKER_SETS
from torch_targets_common import chessboard_sheet, grid_error, jittered_quad, marker_sheet, posed_views, sheet_view

CHESS_ATOL = 1.5e-4
ARUCO_ATOL = 0.02
FRAME_WH = (480, 360)
DICT = "DICT_4X4_50"
MARKER_IDS = (3, 17, 44)


def _chess_frames(n=2, seed=4):
    """(frames, truth (n, 35, 2) in print order) of a 6 x 8-square board."""
    rng = np.random.default_rng(seed)
    sheet, xy = chessboard_sheet(6, 8, 40, 30)
    frames, truth = [], []
    for i in range(n):
        quad = jittered_quad(rng, FRAME_WH, 40, 20, sheet.shape[1] / sheet.shape[0])
        f, H = sheet_view(sheet, quad, FRAME_WH, noise_seed=seed + i)
        frames.append(f)
        truth.append(render.project(H, xy))
    return np.stack(frames), np.stack(truth)


def _aruco_frames(n=2, seed=5):
    rng = np.random.default_rng(seed)
    sheet, corners = marker_sheet(DICT, [(3, 30, 40), (17, 200, 60), (44, 90, 180)], (340, 300), 14)
    frames, truth = [], []
    for i in range(n):
        f, H = sheet_view(sheet, jittered_quad(rng, FRAME_WH, 30, 15, 340 / 300), FRAME_WH, noise_seed=seed + i)
        frames.append(f)
        truth.append({m: render.project(H, c) for m, c in corners.items()})
    return np.stack(frames), truth


def _same_packet(got, want, atol):
    np.testing.assert_array_equal(got.object_id, want.object_id)
    np.testing.assert_array_equal(got.keypoint_id, want.keypoint_id)
    if len(want):
        np.testing.assert_array_equal(got.obj_loc, want.obj_loc)
        assert np.abs(got.img_loc - want.img_loc).max() <= atol


@pytest.fixture(scope="module")
def chess():
    frames, truth = _chess_frames()
    jt = JChessboardTracker(JChessboard(5, 7, 0.03))
    return frames, truth, [jt.get_points(f) for f in frames]


@pytest.fixture(scope="module")
def aruco():
    frames, truth = _aruco_frames()
    jms = JArucoMarkerSet(DICT, {i: JArucoMarker(i, 0.05) for i in MARKER_IDS})
    jt = JArucoTracker(jms)
    return frames, truth, jms, [jt.get_points(f) for f in frames], jt.get_points_batch(frames)


def test_chessboard_tracker_matches_jax(chess):
    frames, truth, want = chess
    tracker = ChessboardTracker(Chessboard(5, 7, 0.03), device="cpu")
    assert tracker.name == "CHESSBOARD" and tracker.pixel_format == PixelFormat.GRAY
    for f, w, gt in zip(frames, want, truth):
        got = tracker.get_points(f)
        assert len(got) == 35  # the whole inner grid
        _same_packet(got, w, CHESS_ATOL)
        assert grid_error(got.img_loc, got.keypoint_id, gt, 5, 7) < 0.3


def test_chessboard_all_or_nothing(chess):
    """A board cut by an occluder gives nothing, in both packages."""
    frames, _, _ = chess
    occluded = frames[0].copy()
    occluded[:, 250:] = 128
    assert len(JChessboardTracker(JChessboard(5, 7, 0.03)).get_points(occluded)) == 0
    assert len(ChessboardTracker(Chessboard(5, 7, 0.03), device="cpu").get_points(occluded)) == 0


def test_chessboard_strong_perspective_agrees_with_jax():
    """A quirk of the reference kept by the port: under strong perspective
    (tilts of 0.6-0.9 rad) the lattice ordering often completes no window
    though every corner is detected (the affine basis from the top-left
    candidate leaves far corners beyond its 0.25 residual gate). Both
    packages complete the same views here: 3 of 8."""
    K = np.array([[400.0, 0, 240], [0, 400, 180], [0, 0, 1]])
    sheet, _ = chessboard_sheet(6, 8, 40, 30)
    frames, _ = posed_views(sheet, np.array([[0.03 / 40, 0], [0, 0.03 / 40], [0, 0]]), K, FRAME_WH, 8, seed=31, tilt=(0.6, 0.9))
    jt, tt = JChessboardTracker(JChessboard(5, 7, 0.03)), ChessboardTracker(Chessboard(5, 7, 0.03), device="cpu")
    counts = [(len(jt.get_points(f)), len(tt.get_points(f))) for f in frames]
    assert [j for j, _ in counts] == [t for _, t in counts] == [0, 35, 0, 0, 0, 0, 35, 35]


def test_chessboard_full_tilt_views_of_chip_smoke_match_jax():
    """chip_smoke.py holds the card's chessboard tracker, on views at the
    recipe's full tilt (0.1-0.9 rad), to CHESS_WIDE_CORNERS corners a view:
    the JAX package's tracker and the port's CPU tracker give exactly those
    on the same views."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    import torch_targets_common

    frames, _, _ = chip_smoke.chessboard_views(torch_targets_common, chip_smoke.CHESS_WIDE_SEED)
    jt, tt = JChessboardTracker(JChessboard(5, 7, 0.03)), ChessboardTracker(Chessboard(5, 7, 0.03), device="cpu")
    assert tuple(len(jt.get_points(f)) for f in frames) == chip_smoke.CHESS_WIDE_CORNERS
    assert tuple(len(tt.get_points(f)) for f in frames) == chip_smoke.CHESS_WIDE_CORNERS


def test_aruco_tracker_matches_jax(aruco):
    frames, truth, jms, want, want_batch = aruco
    ms = convert.aruco_marker_set(dataclasses.asdict(jms))
    tracker = ArucoTracker(ms, device="cpu")
    assert tracker.name == "ARUCO" and [tracker.get_point_name(k) for k in range(4)] == ["TL", "TR", "BR", "BL"]
    got_batch = tracker.get_points_batch(frames)
    for f, w, wb, gb, gt in zip(frames, want, want_batch, got_batch, truth):
        got = tracker.get_points(f)
        assert sorted(set(got.object_id.tolist())) == list(MARKER_IDS)
        _same_packet(got, w, ARUCO_ATOL)
        _same_packet(gb, wb, ARUCO_ATOL)
        err = [np.linalg.norm(got.img_loc[i] - gt[int(m)][int(k)]) for i, (m, k) in enumerate(zip(got.object_id, got.keypoint_id))]
        assert np.mean(err) < 0.3


def test_aruco_tracker_skips_markers_outside_its_set(aruco):
    frames, _, _, _, _ = aruco
    ms = ArucoMarkerSet(DICT, {17: ArucoMarker(17, 0.05), 9: ArucoMarker(9, 0.1)})
    got = ArucoTracker(ms, device="cpu").get_points(frames[0])
    assert set(got.object_id.tolist()) == {17} and sorted(got.keypoint_id.tolist()) == [0, 1, 2, 3]
    np.testing.assert_allclose(np.abs(got.obj_loc[:, :2]), 0.025)


def test_trackers_raise_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChessboardTracker(Chessboard(5, 7, 0.03))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArucoTracker(ArucoMarkerSet(DICT, {1: ArucoMarker(1, 0.05)}))


def _jax_marker_sets():
    out = dict(MARKER_SETS)
    out["links_and_pair"] = lambda: JArucoMarkerSet(
        DICT,
        {i: JArucoMarker(i, 0.1, static=i >= 4) for i in range(6)},
        links=(JDistanceLink(0, 1, 0.4), JDistanceLink(4, 5, 0.3, 1, 2, sigma_m=0.001)),
        mirror_pairs=(JMirrorPair(2, 3, 1, 0, thickness_m=0.004, sigma_m=0.002),),
    )
    return out


@pytest.mark.parametrize("name", sorted(_jax_marker_sets()))
def test_marker_set_toml_round_trip_and_constraints(name, tmp_path):
    jms = _jax_marker_sets()[name]()
    ms = convert.aruco_marker_set(dataclasses.asdict(jms))
    assert dataclasses.asdict(ms) == dataclasses.asdict(jms)
    ms.to_toml(tmp_path / "port.toml")
    jms.to_toml(tmp_path / "jax.toml")
    assert (tmp_path / "port.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()
    assert ArucoMarkerSet.from_toml(tmp_path / "jax.toml") == ms
    assert JArucoMarkerSet.from_toml(tmp_path / "port.toml") == jms
    # the constraint compiler on the real target
    assert dataclasses.asdict(ConstraintSet.from_marker_set(ms)) == dataclasses.asdict(JCS.from_marker_set(jms))


@pytest.mark.parametrize("size", [0.03, None])
def test_chessboard_toml_round_trip_and_constraints(size, tmp_path):
    jcb = JChessboard(rows=6, columns=8, square_size_m=size)
    cb = convert.chessboard(dataclasses.asdict(jcb))
    np.testing.assert_array_equal(cb.object_points(), jcb.object_points())
    assert cb.connectivity() == jcb.connectivity()
    cb.to_toml(tmp_path / "port.toml")
    jcb.to_toml(tmp_path / "jax.toml")
    assert (tmp_path / "port.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()
    assert Chessboard.from_toml(tmp_path / "jax.toml") == cb
    if size is None:
        with pytest.raises(ValueError, match="square_size"):
            ConstraintSet.from_chessboard(cb)
    else:
        assert dataclasses.asdict(ConstraintSet.from_chessboard(cb)) == dataclasses.asdict(JCS.from_chessboard(jcb))
    assert ChessboardTracker(cb, device="cpu").get_connected_points() == JChessboardTracker(jcb).get_connected_points()


def test_target_validation_matches_jax():
    with pytest.raises(ValueError):
        Chessboard(1, 5)
    with pytest.raises(ValueError):
        ArucoMarkerSet(DICT, {60: ArucoMarker(60, 0.1)})
    with pytest.raises(ValueError):
        JArucoMarkerSet(DICT, {60: JArucoMarker(60, 0.1)})


def test_wireframe_builder_matches_jax(tmp_path):
    spec = tmp_path / "wire.toml"
    spec.write_text(
        '[points]\nnose = 0\nleft_eye = 1\nright_eye = 2\n\n'
        '[segments.eyes]\ncolor = "r"\npoints = ["left_eye", "right_eye"]\n\n'
        '[segments.bridge]\npoints = ["nose", "left_eye"]\nwidth = 2\n'
    )
    got, want = build_wireframe(spec), j_build_wireframe(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# On the card: the trackers' shapes (B = 1, K = 512) through the kernels
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")


@pytest.mark.cuda
def test_kernels_at_the_trackers_shapes_on_cuda():
    """Kernel 3 at B = 1, kernel 4 at the chessboard's K = 512, win 28, and
    kernel 2 on one 720p frame, each equal to its plain version."""
    _need_cuda()
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(0, 255, size=(1, 720, 1280)).astype(np.float32)).cuda()
    assert torch.equal(CK.corner_response(img), CK.corner_response_plain(img))
    padded = torch.as_tensor(rng.normal(size=(1, 748, 1308)).astype(np.float32)).cuda()
    yi = torch.as_tensor(rng.integers(0, 748 - 28, size=(1, 512)).astype(np.int32)).cuda()
    xi = torch.as_tensor(rng.integers(0, 1308 - 28, size=(1, 512)).astype(np.int32)).cuda()
    assert torch.equal(CK.extract_windows(padded, yi, xi, 28), CK.extract_windows_plain(padded, yi, xi, 28))
    mask = torch.as_tensor(rng.uniform(size=(1, 720, 1280)) < 0.45).cuda()
    assert torch.equal(TC.connected_components(mask, 4), TC.connected_components_plain(mask, 4))


@pytest.mark.cuda
def test_trackers_on_cuda_match_cpu(chess, aruco):
    _need_cuda()
    frames, _, _ = chess
    cpu = ChessboardTracker(Chessboard(5, 7, 0.03), device="cpu").get_points(frames[0])
    got = ChessboardTracker(Chessboard(5, 7, 0.03), device="cuda").get_points(frames[0])
    np.testing.assert_array_equal(got.keypoint_id, cpu.keypoint_id)
    assert np.abs(got.img_loc - cpu.img_loc).max() < 0.05
    frames, _, jms, _, _ = aruco
    ms = convert.aruco_marker_set(dataclasses.asdict(jms))
    cpu = ArucoTracker(ms, device="cpu").get_points(frames[0])
    got = ArucoTracker(ms, device="cuda").get_points(frames[0])
    np.testing.assert_array_equal(got.object_id, cpu.object_id)
    assert np.abs(got.img_loc - cpu.img_loc).max() < 0.05
