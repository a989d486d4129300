"""Persist/load synthetic scenes as reusable test fixtures.

Port of caliscope_tpu/synthetic/fixture_repository.py. A fixture directory
holds the ground-truth cameras (camera_array.toml), the exact observation
tables (CSV), and the scene's object geometry/trajectories (npz), so a
scenario can be replayed without re-running the engine. The port's CSV and
TOML writers are byte-stable, so a saved fixture reloads to the same tables
bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
from caliscope_tpu_torch.synthetic.calibration_object import CalibrationObject
from caliscope_tpu_torch.synthetic.scene import SyntheticScene
from caliscope_tpu_torch.synthetic.se3 import SE3Pose
from caliscope_tpu_torch.synthetic.trajectory import Trajectory


def save_scene_fixture(scene: SyntheticScene, directory: Path | str) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    scene.cameras.to_toml(directory / "camera_array.toml")
    scene.image_points_perfect().to_csv(directory / "image_points_perfect.csv")
    scene.image_points_noisy().to_csv(directory / "image_points_noisy.csv")
    scene.world_points().to_csv(directory / "world_points.csv")
    blob = {
        "noise_sigma_px": np.asarray(scene.noise_sigma_px),
        "seed": np.asarray(scene.seed),
        "n_objects": np.asarray(len(scene.objects)),
    }
    for i, (obj, traj) in enumerate(zip(scene.objects, scene.trajectories)):
        blob[f"obj{i}_points"] = obj.points_local
        blob[f"obj{i}_id"] = np.asarray(obj.object_id)
        blob[f"obj{i}_static"] = np.asarray(obj.static)
        blob[f"obj{i}_traj_R"] = np.stack([p.rotation for p in traj.poses])
        blob[f"obj{i}_traj_t"] = np.stack([p.translation for p in traj.poses])
    np.savez_compressed(directory / "scene.npz", **blob)
    return directory


def load_scene_fixture(directory: Path | str) -> SyntheticScene:
    directory = Path(directory)
    cameras = CameraArray.from_toml(directory / "camera_array.toml")
    with np.load(directory / "scene.npz") as data:
        objects, trajectories = [], []
        for i in range(int(data["n_objects"])):
            objects.append(
                CalibrationObject.from_points(
                    object_id=int(data[f"obj{i}_id"]),
                    points=data[f"obj{i}_points"],
                    static=bool(data[f"obj{i}_static"]),
                )
            )
            poses = tuple(SE3Pose(R, t) for R, t in zip(data[f"obj{i}_traj_R"], data[f"obj{i}_traj_t"]))
            trajectories.append(Trajectory(poses))
        noise_sigma_px = float(data["noise_sigma_px"])
        seed = int(data["seed"])
    return SyntheticScene(cameras, objects, trajectories, noise_sigma_px=noise_sigma_px, seed=seed)


def load_fixture_observations(directory: Path | str) -> tuple[ImagePoints, ImagePoints, WorldPoints]:
    """(perfect, noisy, world) tables exactly as persisted."""
    directory = Path(directory)
    return (
        ImagePoints.from_csv(directory / "image_points_perfect.csv"),
        ImagePoints.from_csv(directory / "image_points_noisy.csv"),
        WorldPoints.from_csv(directory / "world_points.csv"),
    )
