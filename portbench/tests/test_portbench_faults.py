"""`correct` comes out false when the timed path is broken underneath: a
run on the CPU at a test's size, with the look for a card skipped, once for
each fault a cell can have (one card: no exchange between cards)."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import run_tiny


def _patch(monkeypatch, target, make):
    from portbench.harness import resolve

    owner, attr = resolve(target)
    original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
    monkeypatch.setattr(owner, attr, make(original))


def test_track_a_corner_altered_where_it_is_produced(tiny, monkeypatch):
    def make(original):
        def packet_from(self, best, width):
            pkt = original(self, best, width)
            if len(pkt.img_loc):
                pkt.img_loc[0] += 2.0
            return pkt
        return packet_from

    _patch(monkeypatch, "caliscope_tpu_torch.trackers.charuco_tracker:CharucoTracker._packet_from", make)
    out = run_tiny(tiny, "rig4_720p.track")
    assert not out["correct"] and out["checks"]["pos_err_max_px"]["value"] > out["checks"]["pos_err_max_px"]["limit"]


def test_track_half_of_the_batch_left_out(tiny, monkeypatch):
    from caliscope_tpu_torch.packets import PointPacket

    def make(original):
        def get_points_batch(self, frames, cam_id=0, rotation_count=0):
            pkts = original(self, frames, cam_id, rotation_count)
            return pkts[: (len(pkts) + 1) // 2] + [PointPacket.empty() for _ in pkts[(len(pkts) + 1) // 2:]]
        return get_points_batch

    _patch(monkeypatch, "caliscope_tpu_torch.trackers.charuco_tracker:CharucoTracker.get_points_batch", make)
    out = run_tiny(tiny, "rig4_720p.track")
    assert not out["correct"] and out["checks"]["err_p90_px"]["value"] == float("inf")


def test_track_a_kernel_answer_altered(tiny, monkeypatch):
    def make(original):
        def corner_response(images):
            out = original(images).clone()
            out[..., 20, 20] += 1.0
            return out
        return corner_response

    _patch(monkeypatch, "caliscope_tpu_torch.detect.corners:corner_response", make)
    out = run_tiny(tiny, "rig4_720p.track")
    assert not out["correct"] and out["checks"]["kernel_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", ["rig8_1080p.calibrate_truss", "rig8_1080p.calibrate"])
def test_calibrate_a_step_that_returns_its_state_unchanged(tiny, monkeypatch, name):
    def make(original):
        def optimize(self, *args, **kwargs):
            return self
        return optimize

    _patch(monkeypatch, "caliscope_tpu_torch.volume:CaptureVolume.optimize", make)
    out = run_tiny(tiny, name, seconds=0.2)
    assert not out["correct"] and out["checks"]["cam_gap_mm"]["value"] > out["checks"]["cam_gap_mm"]["limit"]


def test_calibrate_half_of_the_batch_left_out(tiny, monkeypatch):
    def make(original):
        def filtered(self, *args, **kwargs):
            vol = original(self, *args, **kwargs)
            keep = np.arange(len(vol.image_points)) % 2 == 0
            return vol._derived(image_points=vol.image_points.select(keep))
        return filtered

    _patch(monkeypatch, "caliscope_tpu_torch.volume:CaptureVolume.filter_by_percentile_error", make)
    out = run_tiny(tiny, "rig8_1080p.calibrate_truss", seconds=0.2)
    assert not out["correct"] and out["checks"]["kept_diff"]["value"] > out["checks"]["kept_diff"]["limit"]
