"""The port's synthetic explorer (caliscope_tpu_torch/synthetic/explorer.py)
against the JAX package's: the same preset catalog and scenes, the
presenter's signals in order through a real pipeline run on the CPU
(bootstrap, optimize, align to the truth) that recovers the rig, and the
alignment and per-camera metrics equal to the JAX package's functions
applied to the same solved volume (1e-9). A failing run emits
pipeline_failed and keeps its error.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from caliscope_tpu.cameras import CameraArray as JaxCameraArray
from caliscope_tpu.cameras import CameraData as JaxCameraData
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.observations import WorldPoints as JaxWorldPoints
from caliscope_tpu.synthetic import explorer as JE
from caliscope_tpu.volume import CaptureVolume as JaxCaptureVolume

from caliscope_tpu_torch.synthetic import explorer as TE
from caliscope_tpu_torch.volume import CaptureVolume
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _wait(cond, timeout=60.0):
    """run_pipeline(block=True) returns when the task's future is set; the
    presenter's done callback, which emits, may run a moment later."""
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_preset_catalog_is_the_jax_packages():
    assert [(p.key, p.label, p.description, p.perturb_focal, p.factory.__name__) for p in TE.SCENE_PRESETS] == [
        (p.key, p.label, p.description, p.perturb_focal, p.factory.__name__) for p in JE.SCENE_PRESETS
    ]


@pytest.fixture(scope="module")
def explored():
    p = TE.ExplorerPresenter(device="cpu")
    events = []
    p.scene_changed.connect(lambda s: events.append("scene_changed"))
    p.pipeline_started.connect(lambda: events.append("pipeline_started"))
    p.stage_complete.connect(lambda name, vol: events.append(name))
    p.pipeline_finished.connect(lambda r: events.append("pipeline_finished"))
    scene = p.select_preset("ring", noise_sigma_px=0.5, seed=42)
    p.run_pipeline(block=True)
    assert _wait(lambda: p.result is not None)
    return p, scene, events


def test_scene_is_the_jax_packages(explored):
    _, scene, _ = explored
    jscene = JE.ExplorerPresenter().select_preset("ring", noise_sigma_px=0.5, seed=42)
    got, want = scene.image_points_noisy(), jscene.image_points_noisy()
    for c in ("sync_index", "cam_id", "object_id", "keypoint_id"):
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c))
    np.testing.assert_allclose(got.img_xy, want.img_xy, rtol=0, atol=1e-9)


def test_pipeline_signals_and_recovery(explored):
    p, _, events = explored
    assert events == ["scene_changed", "pipeline_started", "bootstrapped", "optimized", "aligned", "pipeline_finished"]
    r = p.result
    assert r.error is None and r.preset_key == "ring"
    assert sorted(r.stage_volumes) == ["aligned", "bootstrapped", "ground_truth", "optimized"]
    assert len(r.camera_metrics) == 4 and r.reprojection_rmse < 1.0
    assert r.max_rotation_error_deg < 0.5 and r.max_translation_error_m < 0.005


def _to_jax(volume: CaptureVolume) -> JaxCaptureVolume:
    ip, wp = volume.image_points, volume.world_points
    return JaxCaptureVolume(
        JaxCameraArray({c: JaxCameraData(**dataclasses.asdict(cam)) for c, cam in volume.camera_array.cameras.items()}),
        JaxImagePoints(ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id, ip.img_xy, ip.obj_loc, ip.frame_time),
        JaxWorldPoints(wp.sync_index, wp.object_id, wp.keypoint_id, wp.xyz, wp.frame_time),
    )


def test_alignment_and_metrics_match_jax(explored):
    p, scene, _ = explored
    optimized = p.result.stage_volumes["optimized"]
    truth = scene.cameras
    jtruth = JaxCameraArray({c: JaxCameraData(**dataclasses.asdict(cam)) for c, cam in truth.cameras.items()})
    got = TE.align_to_ground_truth(optimized, truth)
    want = JE.align_to_ground_truth(_to_jax(optimized), jtruth)
    for cid, cam in want.camera_array.cameras.items():
        np.testing.assert_allclose(got.camera_array.cameras[cid].rotation, cam.rotation, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.camera_array.cameras[cid].translation, cam.translation, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.world_points.xyz, want.world_points.xyz, rtol=0, atol=1e-9)
    gm, wm = TE.compare_to_truth(got, truth), JE.compare_to_truth(want, jtruth)
    assert [m.cam_id for m in gm] == [m.cam_id for m in wm]
    for a, b in zip(gm, wm):
        np.testing.assert_allclose(
            [a.rotation_error_deg, a.translation_error_m, a.reprojection_rmse],
            [b.rotation_error_deg, b.translation_error_m, b.reprojection_rmse], rtol=1e-7, atol=1e-9,
        )


def test_failed_pipeline(monkeypatch):
    p = TE.ExplorerPresenter(device="cpu")
    p.select_preset("ring", seed=1)
    failures = []
    p.pipeline_failed.connect(failures.append)

    def boom(*a, **k):
        raise RuntimeError("bootstrap failed")

    monkeypatch.setattr(CaptureVolume, "bootstrap", boom)
    p.run_pipeline(block=True)
    assert _wait(lambda: failures) and failures == ["bootstrap failed"]
    assert p.result.error == "bootstrap failed" and np.isnan(p.result.reprojection_rmse)
    assert np.isnan(p.result.max_rotation_error_deg)
