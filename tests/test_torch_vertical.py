"""The port's vertical estimator (caliscope_tpu_torch/estimators/) held
against the JAX package's on the same numpy inputs, float64 on the CPU:

- fit_gravity on analytic perspective up-fields (a known gravity and K,
  seeded noise), plain, with 15 % outlier pixels and with confidence
  weights: the gravity within 1e-10, the same LM iteration count (read from
  the JAX package's `_fit_one`) and the same `converged` flag;
- estimate_vertical_from_fields over two cameras: the same up vectors
  (1e-10), residuals and frame counts;
- _infer_up_field through the port's executor against the JAX package's
  (cv2 resize and channel swap, OnnxJaxSession) on a seeded frame: the JAX
  suite's constant surrogate equal to 1e-6, and a 1x1 convolution that
  passes two color channels through, which exposes the resize (the port's
  is within 1 gray level of cv2's) and the channel order;
- the chain on the video of tests/test_pose_and_vertical.py:160-197: the
  JAX package's estimate_vertical against the port's
  estimate_vertical_from_frames on the same frames, decoded here with this
  machine's OpenCV; the port's estimate_vertical on the CPU refuses that
  mp4v file (CalibrationError: MPEG-4 Part 2 decodes only on the CUDA
  device's NVDEC) and, on the same frames written uncompressed, gives the JAX package's
  estimate on that file.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from caliscope_tpu.estimators import vertical as JV
from caliscope_tpu.estimators import vertical_solver as JS
from caliscope_tpu.pose import onnx_proto as JPR
from caliscope_tpu.pose.onnx_jax import OnnxJaxSession
from caliscope_tpu.pose.torch_onnx import GraphBuilder

from caliscope_tpu_torch.estimators import vertical as TV
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.media.video import OverlayVideoWriter
from caliscope_tpu_torch.estimators import vertical_solver as TS
from caliscope_tpu_torch.pose import onnx_proto as TPR
from caliscope_tpu_torch.pose.onnx_torch import OnnxTorchSession
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = np.array([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]])
GRAVITY_ATOL = 1e-10


def analytic_field(g, K, H=240, W=320, noise=0.01, seed=0):
    """The exact perspective up-field of camera-frame gravity g, plus noise
    (tests/test_pose_and_vertical.py:71-83)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    pnx = (xs - K[0, 2]) / K[0, 0]
    pny = (ys - K[1, 2]) / K[1, 1]
    f = np.stack([g[0] - pnx * g[2], g[1] - pny * g[2]], axis=-1)
    f /= np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-9)
    return f + rng.normal(scale=noise, size=f.shape)


def unit(v):
    v = np.asarray(v, float)
    return v / np.linalg.norm(v)


def jax_fit(monkeypatch, field, weights=None):
    """The JAX package's fit and its LM iteration count."""
    seen = {}
    original = JS._fit_one

    def spy(*args, **kwargs):
        out = original(*args, **kwargs)
        seen["iterations"] = int(out[2])
        return out

    monkeypatch.setattr(JS, "_fit_one", spy)
    return JS.fit_gravity(field, K, weights=weights), seen["iterations"]


@pytest.mark.parametrize("case", ["plain", "outliers", "weighted"])
def test_fit_gravity_matches_jax(monkeypatch, case):
    g = unit([0.15, 0.97, 0.19] if case == "plain" else [0.0, 0.95, 0.3])
    field = analytic_field(g, K, noise=0.02 if case == "outliers" else 0.01, seed=1)
    rng = np.random.default_rng(2)
    if case == "outliers":
        mask = rng.uniform(size=field.shape[:2]) < 0.15
        field[mask] = rng.normal(size=(mask.sum(), 2))
    weights = rng.uniform(0.2, 1.0, size=field.shape[:2]) if case == "weighted" else None
    want, iterations = jax_fit(monkeypatch, field, weights)
    got = TS.fit_gravity(field, K, weights=weights, device="cpu")
    np.testing.assert_allclose(got.gravity_cam, want.gravity_cam, atol=GRAVITY_ATOL, rtol=0)
    assert got.iterations == iterations and got.converged == want.converged
    np.testing.assert_allclose([got.residual_deg, got.inlier_fraction], [want.residual_deg, want.inlier_fraction], atol=1e-9)
    assert np.degrees(np.arccos(min(1.0, abs(got.gravity_cam @ g)))) < 2.0


def test_estimate_vertical_from_fields_matches_jax():
    g = {3: unit([0.1, 0.98, 0.15]), 5: unit([-0.2, 0.9, -0.1])}
    fields = {cid: [analytic_field(gc, K, seed=s) for s in range(3)] for cid, gc in g.items()}
    Ks = {cid: K for cid in g}
    want = JV.estimate_vertical_from_fields(fields, Ks)
    got = TV.estimate_vertical_from_fields(fields, Ks, device="cpu")
    assert got.cam_ids == want.cam_ids == [3, 5]
    for cid in got.cam_ids:
        np.testing.assert_allclose(got.up_by_camera[cid], want.up_by_camera[cid], atol=GRAVITY_ATOL, rtol=0)
        np.testing.assert_allclose(got.residual_deg_by_camera[cid], want.residual_deg_by_camera[cid], atol=1e-9)
        assert got.n_frames_by_camera[cid] == want.n_frames_by_camera[cid]


def surrogate(weights=None, bias=(0.0, -1.0), hw=(240, 320)):
    """The JAX suite's perspective-field surrogate: one 1x1 convolution to
    two channels (zero weights and bias (0, -1): a level camera's constant
    up-field), written by the JAX package's writer."""
    b = GraphBuilder("input", (1, 3, *hw))
    w = np.zeros((2, 3, 1, 1), np.float32) if weights is None else np.asarray(weights, np.float32).reshape(2, 3, 1, 1)
    out = b.node("Conv", ["input", b.init(w, "w"), b.init(np.asarray(bias, np.float32), "b")],
                 kernel_shape=[1, 1], strides=[1, 1], pads=[0, 0, 0, 0])[0]
    return JPR.write_model(b.finish([out]))


@pytest.mark.parametrize("kind", ["constant", "channels"])
def test_infer_up_field_matches_jax(kind):
    """The port resizes on the device as cv2.resize does (within 1 gray
    level) and swaps BGR to RGB: the 'channels' surrogate reads R into x and
    B into y."""
    data = surrogate() if kind == "constant" else surrogate([[1, 0, 0], [0, 0, 1]], (0.0, 0.0))
    frame = np.random.default_rng(0).integers(0, 255, (96, 128, 3)).astype(np.uint8)
    want, want_w = JV._infer_up_field(OnnxJaxSession(JPR.parse_model(data)), frame)
    got, got_w = TV._infer_up_field(OnnxTorchSession(TPR.parse_model(data), device="cpu"), frame)
    assert got.shape == want.shape == (240, 320, 2) and got_w is None and want_w is None
    diff = np.abs(got - want)
    if kind == "constant":
        assert diff.max() <= 1e-6
    else:
        assert diff.max() <= 1 / 255 + 1e-6 and np.mean(diff <= 1e-6) > 0.99
        # R -> x, B -> y: the frame's last channel lands in x
        np.testing.assert_allclose(got[0, 0], frame[0, 0, [2, 0]] / 255.0, atol=1 / 255 + 1e-6)


def test_chain_on_the_jax_suites_video(tmp_path):
    cv2 = pytest.importorskip("cv2")
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    (models_dir / TV.GEOCALIB_FILENAME).write_bytes(surrogate())
    video = tmp_path / "cam_0.mp4"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (128, 96))
    rng = np.random.default_rng(0)
    for _ in range(8):
        vw.write(rng.integers(0, 255, (96, 128, 3)).astype(np.uint8))
    vw.release()
    Kv = np.array([[120.0, 0, 64.0], [0, 120.0, 48.0], [0, 0, 1.0]])
    want = JV.estimate_vertical({0: video}, {0: Kv}, models_dir, n_sample_frames=3)

    cap = cv2.VideoCapture(str(video))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    picks = np.linspace(0, len(frames) - 1, 3, dtype=int)  # estimate_vertical's sampling
    got = TV.estimate_vertical_from_frames({0: [frames[i] for i in picks]}, {0: Kv}, models_dir, device="cpu")
    np.testing.assert_allclose(got.up_by_camera[0], want.up_by_camera[0], atol=GRAVITY_ATOL, rtol=0)
    assert got.n_frames_by_camera == want.n_frames_by_camera == {0: 3}
    up = got.up_by_camera[0]
    assert up[1] > 0.7 and abs(up[0]) < 0.3 and abs(up[2]) < 0.3, up
    with pytest.raises(CalibrationError, match="MPEG-4 Part 2 video decodes only on the CUDA device"):
        TV.estimate_vertical({0: video}, {0: Kv}, models_dir, device="cpu")
    raw = tmp_path / "raw" / "cam_0.mp4"
    with OverlayVideoWriter(raw, (128, 96), 30.0) as w:
        for frame in frames:
            w.write(frame)
    want_raw = JV.estimate_vertical({0: raw}, {0: Kv}, models_dir, n_sample_frames=3)
    got_raw = TV.estimate_vertical({0: raw}, {0: Kv}, models_dir, n_sample_frames=3, device="cpu")
    np.testing.assert_allclose(got_raw.up_by_camera[0], want_raw.up_by_camera[0], atol=GRAVITY_ATOL, rtol=0)
    assert got_raw.n_frames_by_camera == want_raw.n_frames_by_camera == {0: 3}


@pytest.mark.cuda
def test_fit_gravity_on_cuda():
    """The card's default (float64) fit equals the CPU's to roundoff, in the
    same iterations; a float32 fit runs to its cap within 0.05 degrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    g = unit([0.0, 0.95, 0.3])
    field = analytic_field(g, K, noise=0.02, seed=1)
    cpu = TS.fit_gravity(field, K, device="cpu")
    card = TS.fit_gravity(field, K, device="cuda")
    assert card.iterations == cpu.iterations
    np.testing.assert_allclose(card.gravity_cam, cpu.gravity_cam, atol=1e-12, rtol=0)
    f32 = TS.fit_gravity(field, K, device="cuda", dtype=torch.float32)
    assert np.degrees(np.arccos(min(1.0, abs(f32.gravity_cam @ cpu.gravity_cam)))) <= 0.05
