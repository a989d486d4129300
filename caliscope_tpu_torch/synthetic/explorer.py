"""Synthetic Calibration Explorer — pipeline testbed over known ground truth.

Port of caliscope_tpu/synthetic/explorer.py; the pipeline runs on the
presenter's device (CUDA unless device="cpu").

Parity: reference src/caliscope/synthetic/explorer/ (presenter.py:107
ExplorerPresenter, PipelineResult/CameraMetrics, preset catalog in
explorer_tab.py). Runs bootstrap -> optimize -> align-to-truth on factory
scenes and reports exactly how well each stage recovered the cameras —
every number checkable because the scene generated the data.

The presenter is framework-agnostic (presenters/signal.Signal, TaskManager
threads); the GUI tab binds to it through the usual bridge, and headless
callers drive it synchronously with run_pipeline(block=True).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from caliscope_tpu_torch.ops.similarity import SimilarityParams, umeyama
from caliscope_tpu_torch.presenters.signal import Signal
from caliscope_tpu_torch.synthetic import factories
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.scene import SyntheticScene
from caliscope_tpu_torch.tasks import TaskManager
from caliscope_tpu_torch.volume import CaptureVolume

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ScenePreset:
    """A named scene factory (+ optional intrinsic perturbation experiment)."""

    key: str
    label: str
    factory: Callable[..., SyntheticScene]
    description: str = ""
    perturb_focal: float = 0.0  # fractional focal error fed to the pipeline


SCENE_PRESETS: tuple[ScenePreset, ...] = (
    ScenePreset("ring", "Default ring (4 cams)", factories.default_ring_scene,
                "4-camera ring watching an orbiting board"),
    ScenePreset("static", "Ring + static markers", factories.ring_with_static_markers,
                "board orbit plus wall-mounted static markers"),
    ScenePreset("narrow", "Narrow baseline", factories.narrow_baseline_scene,
                "8-degree separation pair — depth is poorly constrained"),
    ScenePreset("depth", "Depth-varied", factories.depth_varied_scene,
                "trajectory sweeps toward/away from the rig"),
    ScenePreset("sparse", "Sparse coverage (6 cams)", factories.sparse_coverage_scene,
                "cameras that share few frames; weak links"),
    ScenePreset("perturbed", "Perturbed intrinsics (+5% focal)", factories.default_ring_scene,
                "pipeline sees wrong focal lengths; extrinsic error follows",
                perturb_focal=0.05),
)


@dataclass(frozen=True)
class CameraMetrics:
    cam_id: int
    rotation_error_deg: float
    translation_error_m: float
    reprojection_rmse: float


@dataclass(frozen=True)
class PipelineResult:
    preset_key: str
    reprojection_rmse: float
    camera_metrics: tuple[CameraMetrics, ...] = ()
    stage_volumes: dict = field(default_factory=dict)  # name -> CaptureVolume
    error: Optional[str] = None

    @property
    def max_rotation_error_deg(self) -> float:
        return max((m.rotation_error_deg for m in self.camera_metrics), default=float("nan"))

    @property
    def max_translation_error_m(self) -> float:
        return max((m.translation_error_m for m in self.camera_metrics), default=float("nan"))


def _geodesic_deg(R_est: np.ndarray, R_gt: np.ndarray) -> float:
    cos = (np.trace(R_est @ R_gt.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def align_to_ground_truth(volume: CaptureVolume, truth) -> CaptureVolume:
    """Similarity-align the solved volume onto the ground-truth rig (camera
    centers, Umeyama WITHOUT scale — the board supplies metric scale and the
    gauge freedom left is SE(3))."""
    est, gt = [], []
    for cid, cam in truth.cameras.items():
        solved = volume.camera_array.cameras.get(cid)
        if solved is None or not solved.is_posed:
            continue
        est.append(-solved.rotation.T @ solved.translation.reshape(3))
        gt.append(-cam.rotation.T @ cam.translation.reshape(3))
    if len(est) < 3:
        return volume
    s, R, t = umeyama(np.asarray(est), np.asarray(gt), with_scale=False)
    return volume._apply_similarity(SimilarityParams(float(s), np.asarray(R), np.asarray(t)))


def compare_to_truth(volume: CaptureVolume, truth) -> tuple[CameraMetrics, ...]:
    rep = volume.reprojection_report
    out = []
    for cid in sorted(truth.cameras):
        solved = volume.camera_array.cameras.get(cid)
        gt = truth.cameras[cid]
        if solved is None or not solved.is_posed:
            continue
        rot_err = _geodesic_deg(solved.rotation, gt.rotation)
        pos_est = -solved.rotation.T @ solved.translation.reshape(3)
        pos_gt = -gt.rotation.T @ gt.translation.reshape(3)
        out.append(
            CameraMetrics(
                cam_id=cid,
                rotation_error_deg=rot_err,
                translation_error_m=float(np.linalg.norm(pos_est - pos_gt)),
                reprojection_rmse=float(rep.by_camera.get(cid, float("nan"))),
            )
        )
    return tuple(out)


class ExplorerPresenter:
    def __init__(self, task_manager: Optional[TaskManager] = None, device=None):
        self._tasks = task_manager or TaskManager(max_workers=1)
        self._device = device
        self._scene: Optional[SyntheticScene] = None
        self._preset: ScenePreset = SCENE_PRESETS[0]
        self._result: Optional[PipelineResult] = None
        self._busy = False

        self.scene_changed = Signal("scene_changed")
        self.pipeline_started = Signal("pipeline_started")
        self.stage_complete = Signal("stage_complete")  # (name, volume)
        self.pipeline_finished = Signal("pipeline_finished")  # PipelineResult
        self.pipeline_failed = Signal("pipeline_failed")  # str

    # ---- scene management -------------------------------------------------------
    @property
    def presets(self) -> tuple[ScenePreset, ...]:
        return SCENE_PRESETS

    @property
    def scene(self) -> Optional[SyntheticScene]:
        return self._scene

    @property
    def result(self) -> Optional[PipelineResult]:
        return self._result

    def select_preset(self, key: str, noise_sigma_px: float = 0.5, seed: int = 42) -> SyntheticScene:
        preset = next(p for p in SCENE_PRESETS if p.key == key)
        self._preset = preset
        self._scene = preset.factory(noise_sigma_px=noise_sigma_px, seed=seed)
        self._result = None
        self.scene_changed.emit(self._scene)
        return self._scene

    # ---- pipeline ------------------------------------------------------------------
    def run_pipeline(self, block: bool = False):
        if self._busy:
            return None
        if self._scene is None:
            self.select_preset(self._preset.key)
        scene = self._scene
        preset = self._preset
        self._busy = True
        self.pipeline_started.emit()

        def work():
            truth = scene.cameras
            ip = scene.image_points_noisy()
            seeded = strip_extrinsics(truth)
            if preset.perturb_focal:
                for cam in seeded.cameras.values():
                    cam.matrix = cam.matrix.copy()
                    cam.matrix[0, 0] *= 1.0 + preset.perturb_focal
                    cam.matrix[1, 1] *= 1.0 + preset.perturb_focal
            stages: dict = {"ground_truth": None}
            vol = CaptureVolume.bootstrap(ip, seeded, device=self._device)
            stages["bootstrapped"] = vol
            self.stage_complete.emit("bootstrapped", vol)
            vol = vol.optimize()
            stages["optimized"] = vol
            self.stage_complete.emit("optimized", vol)
            aligned = align_to_ground_truth(vol, truth)
            stages["aligned"] = aligned
            self.stage_complete.emit("aligned", aligned)
            return PipelineResult(
                preset_key=preset.key,
                reprojection_rmse=float(aligned.reprojection_report.overall_rmse),
                camera_metrics=compare_to_truth(aligned, truth),
                stage_volumes=stages,
            )

        def on_done(fut):
            self._busy = False
            try:
                self._result = fut.result()
                self.pipeline_finished.emit(self._result)
            except Exception as e:
                logger.exception("explorer pipeline failed")
                self._result = PipelineResult(preset_key=preset.key, reprojection_rmse=float("nan"), error=str(e))
                self.pipeline_failed.emit(str(e))

        handle = self._tasks.submit(work, name="explorer_pipeline")
        handle.future.add_done_callback(on_done)
        if block:
            handle.future.exception()
        return handle
