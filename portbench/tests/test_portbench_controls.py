"""The controls at a test's size: each fails the cell's numbers that the
limits were set to catch (portbench/controls.py reads them on the card at
the cells' own sizes)."""

from __future__ import annotations

import json

import numpy as np
import torch

from conftest import HERE, SEED
from portbench.gen import render
from portbench.reference import detect_plain, tracking_check


def limits(cell):
    return json.loads((HERE / "workloads" / f"{cell}.json").read_text())["limits"]


def test_the_corners_in_bfloat16_fail_the_tracking_limits():
    """The exact projections of the full-size rig rounded to bfloat16."""
    cfg = json.loads((HERE / "configs" / "rig4_720p.json").read_text())
    rig, b, ses = cfg["rig"], cfg["board"], cfg["session"]
    wh = tuple(rig["size"])
    cams = render.ring_cameras(rig["cameras"], wh, rig["focal_px"], rig["ring_radius_m"], rig["ring_height_m"], rig["aim_m"])
    poses = render.station_poses(ses["stations"], ses["frames_per_camera_source"] // ses["stations"], 4, rig["aim_m"],
                                 (b["columns"] * b["square_m"], b["rows"] * b["square_m"]),
                                 np.random.default_rng(SEED), 0.005, 0.01)
    views = [[render.view(c, p, b["rows"], b["columns"], b["square_m"], b["print_px_per_square"], 84, wh)
              for p in poses[:40]] for c in cams]
    truth = np.array([[v[1] for v in row] for row in views])
    visible = np.array([[v[2] for v in row] for row in views])
    nums = tracking_check.control_numbers(truth, visible)
    lim = limits("rig4_720p.track")
    assert nums["pos_err_max_px"] > lim["pos_err_max_px"] and nums["err_p90_px"] > lim["err_p90_px"]
    exact = tracking_check.corner_numbers(*np.nonzero(visible), truth[visible], truth, visible)
    assert exact["pos_err_max_px"] == 0 and exact["stray"] == 0 and exact["err_p90_px"] == 0


def test_the_response_in_bfloat16_is_not_the_programs():
    cfg = json.loads((HERE / "configs" / "rig4_720p.json").read_text())
    cfg["rig"].update(cameras=2, size=[320, 192], focal_px=450.0)
    cfg["board"]["print_px_per_square"] = 42
    cfg["session"].update(frames_per_camera_source=48, frames_per_camera=6)
    frames, *_ = render.render_rig(cfg, {"jitter_m": 0.005, "jitter_rad": 0.01}, SEED, torch.device("cpu"))
    images = frames.reshape(-1, 192, 320).to(torch.float32)
    from caliscope_tpu_torch.detect import cuda_kernels

    program = cuda_kernels.corner_response(images)  # the plain path of the program on the CPU
    assert torch.equal(detect_plain.corner_response(images), program)
    assert int((detect_plain.corner_response(images, dtype=torch.bfloat16) != program).sum()) > 0


def test_the_reference_in_bfloat16_fails_the_calibrate_limits(tiny):
    from portbench import harness
    from portbench.controls import calibrate_readings

    for name in ("rig8_1080p.calibrate_truss", "rig8_1080p.calibrate"):
        cell = harness.Cell(name, tiny, here=tiny)
        nums = calibrate_readings(cell, SEED, torch.device("cpu"), control=True)
        lim = limits(name)
        failed = [k for k, v in nums.items() if v > lim[k]]
        assert {"cam_gap_mm", "pt_gap_mm", "rmse_gap"} <= set(failed), nums
