"""The port's cameras, observations and conversion held against the JAX
package's: device views, camera files byte for byte, host projection and
undistortion, and `ImagePoints.triangulate` (float64, CPU; tolerance 1e-10
as in tests/test_torch_ops.py, points compared, never eigenvectors).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import caliscope_tpu as CT
from caliscope_tpu_torch import convert
from caliscope_tpu_torch.cameras import CameraArray, CameraData
from caliscope_tpu_torch.observations import ImagePoints

TOL = 1e-10


def _jax_rig():
    """Five cameras: a ring of three posed Brown cameras, one posed fisheye
    camera, one unposed and one ignored."""
    cams = {}
    for i in range(4):
        a = 2 * np.pi * i / 4
        c = np.array([2.5 * np.cos(a), 2.5 * np.sin(a), 0.9])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        fisheye = i == 3
        cams[i] = CT.CameraData(
            cam_id=i, size=(1280, 720), matrix=[[820.0 + i, 0, 640], [0, 815.0, 360], [0, 0, 1]],
            distortions=[0.02, -0.01, 0.001, 0.0005] if fisheye else [0.1, -0.05, 0.001, -0.001, 0.01],
            rotation=R, translation=-R @ c, fisheye=fisheye, error=0.25 * i, grid_count=10 + i,
        )
    cams[4] = CT.CameraData(cam_id=4, size=(640, 480), matrix=np.eye(3), distortions=np.zeros(5))
    cams[5] = CT.CameraData(cam_id=5, size=(640, 480), ignore=True)
    return CT.CameraArray(cams)


def _port(jcams):
    return convert.camera_array(
        {cid: {f: getattr(c, f) for f in convert.CAMERA_FIELDS} for cid, c in jcams.cameras.items()
         if not c.ignore}
    )


@pytest.fixture(scope="module")
def rigs():
    jcams = _jax_rig()
    return jcams, _port(jcams)


@pytest.mark.parametrize("posed_only", [False, True])
def test_device_views_match_jax(rigs, posed_only):
    jcams, tcams = rigs
    want = jcams.device_views(posed_only=posed_only)
    got = tcams.device_views(posed_only=posed_only, device="cpu")
    np.testing.assert_array_equal(got.cam_ids, want.cam_ids)
    for name in ("K", "dist", "rvec", "tvec", "proj"):
        tensor = getattr(got, name)
        assert isinstance(tensor, torch.Tensor) and tensor.dtype == torch.float64
        np.testing.assert_allclose(tensor.numpy(), getattr(want, name), rtol=TOL, atol=TOL)
    for name in ("fisheye", "posed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name))
    assert tcams.device_views(device="cpu", dtype=torch.float32).K.dtype == torch.float32


@pytest.mark.parametrize("writer", ["to_toml", "to_aniposelib_toml"])
def test_camera_files_byte_identical(rigs, tmp_path, writer):
    jcams, _ = rigs
    jcams.to_toml(tmp_path / "src.toml")
    getattr(CT.CameraArray.from_toml(tmp_path / "src.toml"), writer)(tmp_path / "jax.toml")
    getattr(CameraArray.from_toml(tmp_path / "src.toml"), writer)(tmp_path / "port.toml")
    assert (tmp_path / "port.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()


@pytest.mark.parametrize("cam_id", [0, 3], ids=["brown", "fisheye"])
def test_host_projection_and_undistortion(rigs, rng, cam_id):
    jcams, tcams = rigs
    jc, tc = jcams.cameras[cam_id], tcams.cameras[cam_id]
    X = rng.uniform(-0.5, 0.5, size=(30, 3))
    np.testing.assert_allclose(tc.project_points(X), jc.project_points(X), rtol=TOL, atol=TOL)
    uv = rng.uniform([100, 100], [1180, 620], size=(30, 2))
    for output in ("normalized", "pixels"):
        np.testing.assert_allclose(
            tc.undistort_points(uv, output=output), jc.undistort_points(uv, output=output), rtol=TOL, atol=TOL
        )
    np.testing.assert_allclose(tc.rvec, jc.rvec, rtol=0, atol=0)  # the host twin is the numpy path


def test_camera_mutation_helpers(rigs):
    _, tcams = rigs
    cams = tcams.copy()
    cams.update_extrinsics(0, np.array([0.1, -0.2, 0.3]), np.array([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(cams.cameras[0].rvec, [0.1, -0.2, 0.3], atol=1e-15)
    assert not np.allclose(tcams.cameras[0].translation, [1.0, 2.0, 3.0])  # copy is deep
    blind = CameraData(cam_id=9, size=(800, 600))
    blind.synthesize_default_intrinsics()
    np.testing.assert_array_equal(blind.matrix, [[400, 0, 400], [0, 400, 300], [0, 0, 1]])
    assert sorted(tcams.posed_cameras) == [0, 1, 2, 3] and tcams.cam_id_to_index[4] == 4


def test_convert_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown fields"):
        convert.camera_array({0: {"matrix": np.eye(3), "skew": 0.0}})


def _observations(rng, jcams):
    """Every posed camera sees 25 points of a moving object over 3 frames and
    the 4 corners of a static marker in every frame; a third of the rows are
    dropped; frame times are set."""
    rows = []
    X = rng.uniform(-0.4, 0.4, size=(3, 25, 3))
    marker = rng.uniform(-0.3, 0.3, size=(4, 3))
    for cid in (0, 1, 2, 3):
        cam = jcams.cameras[cid]
        for s in range(3):
            uv = cam.project_points(X[s]) + rng.normal(scale=0.3, size=(25, 2))
            rows += [(s, cid, 0, k, *uv[k]) for k in range(25)]
            uvm = cam.project_points(marker)
            rows += [(s, cid, 7, k, *uvm[k]) for k in range(4)]
    rows = np.array(rows)
    rows = rows[rng.uniform(size=len(rows)) > 0.33]
    ft = rows[:, 0] * 0.033 + rows[:, 1] * 1e-3
    cols = dict(sync_index=rows[:, 0], cam_id=rows[:, 1], object_id=rows[:, 2], keypoint_id=rows[:, 3],
                img_xy=rows[:, 4:6], frame_time=ft)
    return CT.ImagePoints(**cols), convert.image_points(cols)


@pytest.mark.parametrize("static", [False, True], ids=["moving", "static_marker"])
def test_triangulate_matches_jax(rigs, rng, static):
    jcams, tcams = rigs
    jip, tip = _observations(rng, jcams)
    statics = frozenset({7}) if static else frozenset()
    want = jip.triangulate(jcams, static_object_ids=statics)
    got = tip.triangulate(tcams, static_object_ids=statics, device="cpu")
    np.testing.assert_array_equal(got.keys(), want.keys())
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.frame_time, want.frame_time, rtol=TOL, atol=TOL)


def test_triangulate_empty_and_unposed(rigs):
    _, tcams = rigs
    assert len(ImagePoints.empty().triangulate(tcams, device="cpu")) == 0
    only_unposed = ImagePoints([0, 0], [4, 4], [0, 0], [0, 1], [[1.0, 2.0], [3.0, 4.0]])
    assert len(only_unposed.triangulate(tcams, device="cpu")) == 0


def test_eigh_chunking_is_transparent(monkeypatch, rng):
    """Batches above the eigensolver's chunk run in chunks with the same
    result (cuSOLVER refuses batches of 32,768 and more)."""
    import caliscope_tpu_torch.ops.triangulate as TT

    A = torch.as_tensor(rng.normal(size=(50, 6, 4)))
    M = A.transpose(1, 2) @ A
    whole = TT._eigh_batched(M)
    monkeypatch.setattr(TT, "EIGH_BATCH", 7)
    chunked = TT._eigh_batched(M)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a.abs(), b.abs(), rtol=1e-12, atol=1e-12)
