"""The port's frame selection (caliscope_tpu_torch.frame_selector) gives the
JAX package's list and report exactly, on the JAX suite's own selection
cases (tests/test_selection_and_reporting.py) carried across with
`convert.image_points`. Host numpy on both sides, so equality is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from caliscope_tpu import frame_selector as JF
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu_torch import convert
from caliscope_tpu_torch import frame_selector as TF
from test_selection_and_reporting import IMAGE_SIZE, _diverse_specs, _make_image_points


def _sparse():
    ip = _make_image_points(_diverse_specs())
    keep = ~((ip.sync_index == 12) & (ip.keypoint_id >= JF.MIN_CORNERS_PER_FRAME - 1))
    return ip.select(keep)


def _frontal():
    rng = np.random.default_rng(3)
    return _make_image_points([(0.5, 0.0, (rng.uniform(300, 1000), rng.uniform(200, 520))) for _ in range(15)])


def _two_cameras():
    a = _make_image_points(_diverse_specs(), cam_id=0)
    b = _make_image_points([(25.0, k * 60.0, (500, 300)) for k in range(6)], cam_id=3)
    cols = {f: np.concatenate([getattr(a, f), getattr(b, f)]) for f in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc")}
    return JaxImagePoints(**cols)


# name -> (image points, cam_id, target_frames)
CASES = {
    "diverse_default": (lambda: _make_image_points(_diverse_specs()), 0, JF.TARGET_FRAMES),
    "diverse_budget_20": (lambda: _make_image_points(_diverse_specs()), 0, 20),
    "sparse_frame_rejected": (_sparse, 0, JF.TARGET_FRAMES),
    "frontal_only_fallback": (_frontal, 0, 8),
    "empty": (JaxImagePoints.empty, 0, JF.TARGET_FRAMES),
    "centered_boards": (lambda: _make_image_points([(30.0, k * 45.0, (640, 360)) for k in range(8)]), 0, JF.TARGET_FRAMES),
    "corner_boards": (
        lambda: _make_image_points(
            [(30.0, k * 90.0, c) for k, c in enumerate([(130, 90), (1150, 90), (130, 630), (1150, 630)])]
        ),
        0,
        JF.TARGET_FRAMES,
    ),
    "second_camera_of_two": (_two_cameras, 3, 4),
}


def _port_points(jip):
    return convert.image_points({f: getattr(jip, f) for f in convert.IMAGE_POINT_FIELDS})


@pytest.mark.parametrize("name", sorted(CASES))
def test_selection_matches_jax(name):
    make, cam_id, target = CASES[name]
    jip = make()
    want_sel, want_rep = JF.select_calibration_frames(jip, cam_id, IMAGE_SIZE, target)
    got_sel, got_rep = TF.select_calibration_frames(_port_points(jip), cam_id, IMAGE_SIZE, target)
    assert got_sel == want_sel
    assert type(got_sel) is list and all(type(s) is int for s in got_sel)
    assert got_rep.__dict__ == want_rep.__dict__
    if name == "frontal_only_fallback":
        assert not got_rep.orientation_sufficient and len(got_sel) == got_rep.n_candidate_frames
    if name == "empty":
        assert got_sel == [] and got_rep == TF.IntrinsicCoverageReport(0.0, 0.0, 0.0, False, 0, (), 0)


def test_constants_and_cell_helpers_match_jax():
    for name in ("GRID_SIZE", "N_ORIENTATION_BINS", "TARGET_FRAMES", "MIN_CORNERS_PER_FRAME", "TILT_MIN_DEG"):
        assert getattr(TF, name) == getattr(JF, name)
    assert TF._EDGE_CELLS == JF._EDGE_CELLS and TF._CORNER_CELLS == JF._CORNER_CELLS
    assert [TF._cell_weight(c) for c in range(25)] == [JF._cell_weight(c) for c in range(25)]
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20, 1300, size=(200, 2))
    assert TF._grid_cells(xy, IMAGE_SIZE) == JF._grid_cells(xy, IMAGE_SIZE)
    for _ in range(20):
        H = np.eye(3) + rng.normal(scale=[[0.2, 0.2, 30], [0.2, 0.2, 30], [1e-3, 1e-3, 0]])
        assert TF._orientation_features(H, IMAGE_SIZE) == JF._orientation_features(H, IMAGE_SIZE)
