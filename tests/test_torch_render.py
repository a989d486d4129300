"""The renderer behind the port's detection tests and chip_smoke.py's ground
truth: `warp_perspective` samples only the bounding box of the source's
outline, and must give the frame that warping every pixel gives, byte for
byte (no tolerance)."""

from __future__ import annotations

import numpy as np
import pytest

from caliscope_tpu_torch.targets import render

OUT_WH = (160, 120)


def _image():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (45, 60), dtype=np.uint8)


def _pose_homography(img, rz, tilt, t):
    """Board pixels (x, y) -> image pixels through a pinhole (f = 150 px) for
    the board plane X = 0.002 * (x, y, 0) rotated by tilt about the image's
    x axis and rz about its z axis, then moved by t (m)."""
    K = np.array([[150.0, 0, OUT_WH[0] / 2], [0, 150.0, OUT_WH[1] / 2], [0, 0, 1]])
    c, s = np.cos(tilt), np.sin(tilt)
    Rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    c, s = np.cos(rz), np.sin(rz)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    R = Rz @ Rx
    Hs, Ws = img.shape
    centre = 0.002 * np.array([Ws / 2, Hs / 2, 0])
    A = np.column_stack([0.002 * R[:, 0], 0.002 * R[:, 1], np.asarray(t) - R @ centre])
    return K @ A


def _corner_depths(img, H):
    Hs, Ws = img.shape
    return (np.array([[-1.0, -1, 1], [Ws, -1, 1], [Ws, Hs, 1], [-1, Hs, 1]]) @ H.T)[:, 2]


CASES = {
    "inside": lambda img: render.homography_from_points(
        np.array([[0, 0], [60, 0], [60, 45], [0, 45]], float), np.array([[30.3, 20.7], [121.9, 25.2], [115.4, 98.6], [27.8, 90.1]])
    ),
    "partly_off_left_top": lambda img: render.homography_from_points(
        np.array([[0, 0], [60, 0], [60, 45], [0, 45]], float), np.array([[-40.2, -30.6], [70.3, -12.4], [66.1, 60.8], [-35.5, 55.2]])
    ),
    "partly_off_right_bottom": lambda img: render.homography_from_points(
        np.array([[0, 0], [60, 0], [60, 45], [0, 45]], float), np.array([[100.4, 70.2], [210.8, 75.3], [205.6, 170.9], [98.2, 160.7]])
    ),
    "wholly_off": lambda img: render.homography_from_points(
        np.array([[0, 0], [60, 0], [60, 45], [0, 45]], float), np.array([[300.0, 10], [360, 12], [358, 50], [301, 48]])
    ),
    "larger_than_the_frame": lambda img: render.homography_from_points(
        np.array([[0, 0], [60, 0], [60, 45], [0, 45]], float), np.array([[-80.0, -90], [260, -70], [250, 230], [-60, 215]])
    ),
    "a_corner_near_the_camera_plane": lambda img: _pose_homography(img, 0.3, 1.2, (0.0, 0.0, 0.05)),
    "a_corner_behind_the_camera": lambda img: _pose_homography(img, 0.3, 1.45, (0.0, 0.0, 0.03)),
}


@pytest.mark.parametrize("border_value", [255.0, 0.0, 128.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_box_warp_equals_the_whole_frames(case, border_value):
    img = _image()
    H = CASES[case](img)
    depths = _corner_depths(img, H)
    if case == "a_corner_near_the_camera_plane":
        assert 0 < depths.min() < 0.1 * depths.max()
    if case == "a_corner_behind_the_camera":
        assert depths.min() < 0 < depths.max()
    got = render.warp_perspective(img, H, OUT_WH, border_value)
    want = render._warp_box(img, H, (0, OUT_WH[0]), (0, OUT_WH[1]), border_value)
    assert got.dtype == np.uint8 and got.shape == (OUT_WH[1], OUT_WH[0])
    np.testing.assert_array_equal(got, want)
    if case not in ("wholly_off", "a_corner_behind_the_camera"):
        assert (want != np.uint8(border_value)).any()
