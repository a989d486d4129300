"""The benchmark's generators: the same seed gives the same inputs, and the
frozen copies make what the program's own generators and reader make."""

from __future__ import annotations

import json

import numpy as np
import torch

from conftest import HERE
from portbench.gen import quicktime, render, ring


def test_ring_scene_repeats_per_seed():
    cfg = json.loads((HERE / "configs" / "rig8_1080p.json").read_text())
    a, b, c = ring.ring_scene(cfg, 2**31 + 5), ring.ring_scene(cfg, 2**31 + 5), ring.ring_scene(cfg, 7)
    assert len(a["sync"]) == cfg["expected"]["observations"] == 168_000
    assert len(np.unique(np.stack([a["sync"], a["kp"]], 1), axis=0)) == cfg["expected"]["points"]
    assert np.array_equal(a["uv"], b["uv"]) and np.array_equal(a["sync"], c["sync"])
    assert not np.array_equal(a["uv"], c["uv"])  # the seed moves the noise only
    assert np.array_equal(a["uv_exact"], c["uv_exact"])


def test_ring_scene_is_the_ports_default_ring_scene():
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene

    cfg = json.loads((HERE / "configs" / "rig8_1080p.json").read_text())
    cfg["rig"]["cameras"], cfg["session"]["frames"] = 4, 20
    mine = ring.ring_scene(cfg, 42)
    scene = default_ring_scene(4, 20)
    ip = scene.image_points_noisy()
    assert np.array_equal(ip.sync_index, mine["sync"]) and np.array_equal(ip.cam_id, mine["cam"])
    assert np.array_equal(ip.keypoint_id, mine["kp"])
    np.testing.assert_allclose(ip.img_xy, mine["uv"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(scene.world_points().xyz, mine["world"].reshape(-1, 3), rtol=0, atol=1e-12)


def _tiny_rig():
    cfg = json.loads((HERE / "configs" / "rig4_720p.json").read_text())
    cfg["rig"].update(cameras=2, size=[160, 96], focal_px=225.0)
    cfg["board"]["print_px_per_square"] = 21
    cfg["session"].update(frames_per_camera_source=16, frames_per_camera=4)
    return cfg, json.loads((HERE / "traffic" / "track.json").read_text())


def test_render_repeats_per_seed_and_draws_the_board_where_its_face_is_seen():
    cfg, traffic = _tiny_rig()
    f1, t1, v1, d1 = render.render_rig(cfg, traffic, 2**31 + 9, torch.device("cpu"))
    f2, t2, v2, d2 = render.render_rig(cfg, traffic, 2**31 + 9, torch.device("cpu"))
    f3, t3, _v3, d3 = render.render_rig(cfg, traffic, 3, torch.device("cpu"))
    assert torch.equal(f1, f2) and np.array_equal(t1, t2) and np.array_equal(v1, v2)
    assert not np.array_equal(t1, t3)  # the jitter moves the board a little
    assert np.array_equal(d1, d3)  # but not which views see its face
    assert d1.any() and not d1.all()
    white = f1[torch.as_tensor(~d1)]
    assert bool((white == 255).all()) and not v1[~d1].any()


def test_board_image_is_the_ports_print():
    from caliscope_tpu_torch.targets.charuco import Charuco

    ours = render.board_image(5, 7, 40)
    assert np.array_equal(ours, Charuco(rows=5, columns=7, square_size_m=0.09).board_image(px_per_square=40))


def test_quicktime_reads_back_through_the_ports_reader(tmp_path):
    from caliscope_tpu_torch.media.video import FrameSource, read_video_properties
    from caliscope_tpu_torch.packets import PixelFormat

    frames = np.random.default_rng(1).integers(0, 256, size=(3, 24, 40), dtype=np.uint8)
    path = tmp_path / "cam_0.mp4"
    quicktime.write_gray(path, frames, 30.0)
    props = read_video_properties(path)
    assert (props.frame_count, props.width, props.height) == (3, 40, 24) and abs(props.fps - 30.0) < 1e-9
    with FrameSource(path, 0, pixel_format=PixelFormat.GRAY, device="cpu") as src:
        got = np.stack([p.frame for p in src])
    assert np.array_equal(got, frames)
