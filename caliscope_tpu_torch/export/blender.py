"""Standalone-Blender scene script writer.

Port of caliscope_tpu/export/blender.py (host code): cameras with footage
backgrounds, animated point clouds, wireframe edges, embedded bpy main. The
emitted artifact is a self-contained .py meant to run inside Blender
(`blender --python scene.py`) plus a JSON data sidecar; this module never
imports bpy itself.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from caliscope_tpu_torch.cameras import CameraArray
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, WorldPoints

logger = logging.getLogger(__name__)

_BPY_TEMPLATE = '''"""Auto-generated caliscope-tpu Blender scene. Run inside Blender:
    blender --python {script_name}
Loads the JSON sidecar written next to this script."""

import json
from pathlib import Path

import bpy
from mathutils import Matrix, Vector

DATA_PATH = Path(__file__).with_suffix(".json")


def load_data():
    with open(DATA_PATH) as f:
        return json.load(f)


def clear_scene():
    bpy.ops.object.select_all(action="SELECT")
    bpy.ops.object.delete(use_global=False)


def add_cameras(data):
    for cam in data["cameras"]:
        name = "cam_{{}}".format(cam["cam_id"])
        cam_obj = bpy.data.objects.new(name, bpy.data.cameras.new(name))
        bpy.context.collection.objects.link(cam_obj)
        # world_from_cam: column-major 4x4; OpenCV cam -> Blender cam flips Y,Z
        m = Matrix([row for row in cam["world_from_cam"]])
        flip = Matrix(((1, 0, 0, 0), (0, -1, 0, 0), (0, 0, -1, 0), (0, 0, 0, 1)))
        cam_obj.matrix_world = m @ flip
        if cam.get("focal_mm"):
            cam_obj.data.lens = cam["focal_mm"]
        if cam.get("footage"):
            try:
                img = bpy.data.images.load(cam["footage"])
                cam_obj.data.show_background_images = True
                bg = cam_obj.data.background_images.new()
                bg.image = img
            except Exception:
                pass


def add_points(data):
    frames = data["frames"]
    names = data["point_names"]
    spheres = {{}}
    for name in names:
        mesh = bpy.data.meshes.new(name)
        obj = bpy.data.objects.new(name, mesh)
        bpy.context.collection.objects.link(obj)
        bpy.ops.mesh.primitive_uv_sphere_add(radius=data["point_radius"])
        src = bpy.context.active_object
        obj.data = src.data.copy()
        bpy.data.objects.remove(src)
        spheres[name] = obj
    for frame in frames:
        f = frame["sync_index"]
        for name, xyz in frame["points"].items():
            obj = spheres.get(name)
            if obj is None or xyz is None:
                continue
            obj.location = Vector(xyz)
            obj.keyframe_insert(data_path="location", frame=f)
    if frames:
        bpy.context.scene.frame_start = frames[0]["sync_index"]
        bpy.context.scene.frame_end = frames[-1]["sync_index"]


def add_wireframe(data):
    edges = data.get("wireframe_edges") or []
    # edges rendered as a single mesh object updated per frame is left to the
    # viewer; here we add a static object for the first frame as orientation aid
    if not edges or not data["frames"]:
        return


def main():
    clear_scene()
    data = load_data()
    add_cameras(data)
    add_points(data)
    add_wireframe(data)


if __name__ == "__main__":
    main()
'''


def write_blender_scene(
    camera_array: CameraArray,
    world_points: WorldPoints,
    output_path: Path | str,
    tracker=None,
    footage: Optional[dict[int, str]] = None,
    point_radius: float = 0.01,
) -> Path:
    """Write scene.py + scene.json for standalone Blender playback.

    Returns the script path. Cameras are exported as world_from_cam 4x4
    matrices; points as per-sync keyed locations named via the tracker.
    """
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    script_path = output_path.with_suffix(".py")
    json_path = output_path.with_suffix(".json")

    cams = []
    for cid, cam in camera_array.posed_cameras.items():
        T = np.eye(4)
        T[:3, :3] = cam.rotation.T
        T[:3, 3] = -cam.rotation.T @ cam.translation
        focal_mm = None
        if cam.matrix is not None and cam.size:
            # 36mm-equivalent focal for display
            focal_mm = float(cam.matrix[0, 0] / cam.size[0] * 36.0)
        cams.append(
            {
                "cam_id": int(cid),
                "world_from_cam": T.tolist(),
                "focal_mm": focal_mm,
                "footage": (footage or {}).get(int(cid)),
            }
        )

    def point_name(k: int) -> str:
        if tracker is not None:
            try:
                return str(tracker.get_point_name(int(k)))
            except Exception:
                pass
        return f"pt_{int(k)}"

    names = sorted({point_name(k) for k in np.unique(world_points.keypoint_id)})
    frames = []
    for si in sorted(np.unique(world_points.sync_index)):
        if si == STATIC_SYNC_INDEX:
            continue
        sel = world_points.sync_index == si
        pts = {}
        for k, xyz in zip(world_points.keypoint_id[sel], world_points.xyz[sel]):
            pts[point_name(int(k))] = [float(v) for v in xyz]
        frames.append({"sync_index": int(si), "points": pts})

    edges = []
    if tracker is not None and getattr(tracker, "wireframe", None):
        edges = [[int(a), int(b)] for a, b in tracker.wireframe.edges_by_id()]

    data = {
        "cameras": cams,
        "point_names": names,
        "frames": frames,
        "wireframe_edges": edges,
        "point_radius": point_radius,
    }
    json_path.write_text(json.dumps(data))
    script_path.write_text(_BPY_TEMPLATE.format(script_name=script_path.name))
    logger.info(f"Wrote Blender scene: {script_path} (+ {json_path.name})")
    return script_path
