"""The port's exports (caliscope_tpu_torch/export/) and reconstruct_xyz
(caliscope_tpu_torch/reconstruction.py) held against the JAX package's.

The port builds the wide table with numpy where the JAX package pivots with
pandas, and must give the same table (the same sync rows, column names and
values, NaN included) and the same TRC file byte for byte, written to the
same path. The CSVs are compared after parsing (pandas reads both here; the
port itself never imports pandas), the Blender script as text and its JSON
sidecar after json.load. reconstruct_xyz triangulates in float64 on both
sides (the port on the CPU), so its xyz values are held to 1e-9 and the
TRC's 6-decimal cells to 2e-6.
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import pytest

from caliscope_tpu.export import write_blender_scene as jax_blender
from caliscope_tpu.export import xyz_to_trc as jax_trc
from caliscope_tpu.export import xyz_to_wide_labelled as jax_wide
from caliscope_tpu.reconstruction import reconstruct_xyz as jax_reconstruct
from caliscope_tpu.synthetic.factories import default_ring_scene

from caliscope_tpu_torch.export import write_blender_scene, xyz_to_trc, xyz_to_wide_labelled
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX
from caliscope_tpu_torch.reconstruction import reconstruct_xyz
from caliscope_tpu_torch.tracker import Segment, WireFrameView
from torch_pose_common import one_torch_thread, port_cameras, port_points, port_world  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XYZ_TOL = 1e-9


class NamedTracker:
    """The tracker surface the exports read: a name, point names (some
    starting with 'face', which the TRC leaves out) and a wireframe."""

    name = "NAMED"

    def get_point_name(self, keypoint_id: int) -> str:
        return ("face_" if keypoint_id % 7 == 3 else "pt_") + f"{keypoint_id:02d}"

    @property
    def wireframe(self):
        names = {self.get_point_name(k): k for k in range(35)}
        return WireFrameView((Segment("a", "r", "pt_00", "pt_01"), Segment("b", "g", "pt_01", "pt_08")), names)


def world_cases():
    """name -> JAX WorldPoints: the ring's points with 30 fps times; no
    times (synthesized); 25 fps times (rates near an integer); duplicates
    of one keypoint across objects (averaged); NaN cells, a whole NaN
    point and a static row."""
    base = default_ring_scene(n_frames=6, noise_sigma_px=0.0).world_points()
    cases = {}
    wp = base.select(np.ones(len(base), bool))
    wp.frame_time[:] = wp.sync_index / 30.0
    cases["30fps"] = wp
    cases["no_time"] = base.select(np.ones(len(base), bool))
    wp = base.select(np.ones(len(base), bool))
    wp.frame_time[:] = wp.sync_index / 25.0 + 0.011
    cases["25fps"] = wp
    wp = base.select(np.ones(len(base), bool))
    wp.object_id[wp.keypoint_id % 5 == 0] = 4
    wp.keypoint_id[wp.keypoint_id % 5 == 0] = 1
    wp.frame_time[:] = wp.sync_index / 30.0
    cases["duplicates"] = wp
    wp = base.select(np.ones(len(base), bool))
    wp.xyz[3, 1] = np.nan
    wp.xyz[wp.keypoint_id == 6] = np.nan
    wp.xyz[(wp.sync_index == 2)] = np.nan
    wp.sync_index[:2] = STATIC_SYNC_INDEX
    wp.frame_time[:] = np.where(wp.sync_index >= 0, wp.sync_index / 30.0, np.nan)
    cases["nan_and_static"] = wp
    return cases


CASES = world_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_labelled_table_matches_jax(case):
    jwp = CASES[case]
    want = jax_wide(jwp, NamedTracker())
    got = xyz_to_wide_labelled(port_world(jwp), NamedTracker())
    np.testing.assert_array_equal(got.sync_index, want.index.to_numpy())
    assert got.columns == list(want.columns)
    np.testing.assert_array_equal(got.values, want.to_numpy(dtype=float))


@pytest.mark.parametrize("case", sorted(CASES))
def test_trc_is_byte_identical(case, tmp_path):
    jwp = CASES[case]
    target = tmp_path / "motion.csv"
    path = jax_trc(jwp, NamedTracker(), target)
    want = path.read_bytes()
    path.unlink()
    got_path = xyz_to_trc(port_world(jwp), NamedTracker(), target)
    assert got_path == path
    assert got_path.read_bytes() == want


def test_blender_scene_matches_jax(tmp_path):
    scene = default_ring_scene(n_frames=6)
    jwp = CASES["nan_and_static"]
    footage = {0: "cam_0.mp4"}
    jpath = jax_blender(scene.cameras, jwp, tmp_path / "jax" / "scene.py", tracker=NamedTracker(), footage=footage)
    tpath = write_blender_scene(port_cameras(scene.cameras), port_world(jwp), tmp_path / "port" / "scene.py",
                                tracker=NamedTracker(), footage=footage)
    assert tpath.read_text() == jpath.read_text()
    assert json.loads(tpath.with_suffix(".json").read_text()) == json.loads(jpath.with_suffix(".json").read_text())
    compile(tpath.read_text(), str(tpath), "exec")


def read(path):
    return pd.read_csv(path)


def test_reconstruct_xyz_writes_the_jax_packages_files(tmp_path):
    """Gap fill, triangulation and the three files, from noisy points with
    rows dropped (so gaps are filled) and capture times."""
    scene = default_ring_scene(n_frames=8, noise_sigma_px=0.2)
    ip = scene.image_points_noisy()
    keep = np.random.default_rng(2).uniform(size=len(ip)) > 0.1
    ip = ip.select(keep)
    ip.frame_time = ip.sync_index / 30.0
    jax_reconstruct(ip, scene.cameras, NamedTracker(), tmp_path / "jax")
    reconstruct_xyz(port_points(ip), port_cameras(scene.cameras), NamedTracker(), tmp_path / "port", device="cpu")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["xyz_NAMED.csv", "xyz_NAMED.trc", "xyz_NAMED_labelled.csv"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in ("xyz_NAMED.csv", "xyz_NAMED_labelled.csv"):
        want, got = read(tmp_path / "jax" / name), read(tmp_path / "port" / name)
        assert list(got.columns) == list(want.columns)
        np.testing.assert_allclose(got.to_numpy(dtype=float), want.to_numpy(dtype=float), atol=XYZ_TOL, rtol=0)
    jl = (tmp_path / "jax" / "xyz_NAMED.trc").read_bytes().decode().split("\r\n")
    tl = (tmp_path / "port" / "xyz_NAMED.trc").read_bytes().decode().split("\r\n")
    assert len(tl) == len(jl) > 8 and tl[1:6] == jl[1:6]
    body = lambda lines: np.array([[float(v) if v else np.nan for v in r.split("\t")] for r in lines[6:-1]])  # noqa: E731
    np.testing.assert_allclose(body(tl), body(jl), atol=2e-6, rtol=0)


def test_reconstruct_xyz_writes_nothing_when_nothing_triangulates(tmp_path):
    scene = default_ring_scene(n_frames=2)
    cams = port_cameras(scene.cameras)
    ip = port_points(scene.image_points_noisy())
    reconstruct_xyz(ip.select(ip.cam_id == 0), cams, NamedTracker(), tmp_path / "one_view", device="cpu")
    reconstruct_xyz(ip.select(np.zeros(len(ip), bool)), cams, NamedTracker(), tmp_path / "empty", device="cpu")
    assert not (tmp_path / "one_view").exists() and not (tmp_path / "empty").exists()
