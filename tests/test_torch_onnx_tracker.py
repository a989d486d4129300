"""The port's OnnxTracker, letterbox, model cards and tracker registry
(caliscope_tpu_torch/pose/) held against the JAX package's, and the
markerless chain end to end on the CPU.

- letterbox: scale and offset exact; the canvas within 1 gray level of the
  JAX package's cv2.resize(INTER_LINEAR) canvas (the port reproduces
  OpenCV's fixed-point arithmetic; OpenCV rounds a few pixels in its scalar
  paths the other way), and equal on almost every pixel.
- OnnxTracker.get_points on the JAX suite's hand-weighted SimCC blob
  detector (tests/test_onnx_engine.py:133-166; built, with the frames and
  the joints' path, by chip_smoke.py's helpers), the same .onnx file for
  both packages: the same keypoint ids, coordinates within 0.05 px where
  the two canvases are equal (the executors agree to float32 roundoff).
- The chain, chip_smoke.py's (d) on the CPU: 4 cameras watching 3 joints
  on a seeded path inside a 1 m cube, OnnxTracker on every frame, the
  markerless calibrate_extrinsics and reconstruct_xyz to a TRC file, all in
  the port: every camera posed and the median 3D joint error under 0.02 m
  after a similarity (the bound of tests/test_onnx_engine.py:256).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from caliscope_tpu.pose import onnx_proto as JPR
from caliscope_tpu.pose import registry as JREG
from caliscope_tpu.pose.model_card import ModelCard as JaxCard
from caliscope_tpu.pose.onnx_tracker import OnnxTracker as JaxTracker
from caliscope_tpu.pose.onnx_tracker import _BBox as JaxBox
from caliscope_tpu.pose.onnx_tracker import letterbox as jax_letterbox

from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.pose import registry as TREG
from caliscope_tpu_torch.pose.model_card import ModelCard
from caliscope_tpu_torch.pose.onnx_proto import save_model
from caliscope_tpu_torch.pose.onnx_tracker import OnnxTracker, _BBox, create_inference_session, letterbox
from caliscope_tpu_torch.pose.torch_onnx import GraphBuilder
from chip_smoke import CHAIN_MODEL_HW as MODEL_HW
from chip_smoke import blob_detector, render_dots
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CARD = """
[model]
name = "blob3"
model_path = "blob3.onnx"
format = "simcc"
input_size = [160, 128]
confidence_threshold = 0.3

[points]
head = 0
hip = 1
foot = 2
"""


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    """(port card, JAX card) over one blob3.onnx written by the port."""
    d = tmp_path_factory.mktemp("models")
    save_model(blob_detector(*MODEL_HW), d / "blob3.onnx")
    (d / "blob3.toml").write_text(CARD)
    return ModelCard.from_toml(d / "blob3.toml", models_dir=d), JaxCard.from_toml(d / "blob3.toml", models_dir=d)


def test_the_port_writes_the_jax_packages_blob_model(cards):
    card, _ = cards
    assert card.model_path.read_bytes() == JPR.write_model(JPR.parse_model(card.model_path.read_bytes()))


LETTERBOX_CASES = [
    ((720, 1280), (0, 0, 1280, 720), (192, 256)),  # a full 720p frame into RTMPose's input
    ((480, 640), (100.4, 50.2, 300.7, 420.9), (160, 128)),  # a tall box, fractional edges
    ((480, 640), (0, 0, 320, 256), (160, 128)),  # exactly 2x in both axes (OpenCV's area path)
    ((300, 200), (10, 20, 60, 50), (192, 256)),  # upscaling
    ((300, 200), (150, 250, 150, 250), (160, 128)),  # an empty crop
]


@pytest.mark.parametrize("case", range(len(LETTERBOX_CASES)))
@pytest.mark.parametrize("gray", [False, True])
def test_letterbox_matches_cv2(case, gray):
    shape, box, (out_w, out_h) = LETTERBOX_CASES[case]
    rng = np.random.default_rng(case)
    frame = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    frame = np.clip(frame.astype(float) + np.linspace(0, 60, shape[1])[None, :, None], 0, 255).astype(np.uint8)
    if gray:
        frame = frame[..., 1].copy()
    want, jscale, joff = jax_letterbox(frame, JaxBox(*box), out_w, out_h)
    got, scale, off = letterbox(frame, _BBox(*box), out_w, out_h, device="cpu")
    assert scale == jscale
    np.testing.assert_array_equal(off, joff)
    assert got.shape == want.shape and got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 0.01


def test_letterbox_refuses_frames_that_are_not_8_bit():
    with pytest.raises(CalibrationError, match="8-bit"):
        letterbox(np.zeros((40, 40, 3), np.float32), _BBox(0, 0, 40, 40), 16, 16, device="cpu")


def test_get_points_matches_the_jax_tracker(cards):
    """Frames of a moving 3-blob 'leg', one camera's tracking state carried
    from frame to frame on both sides."""
    card, jcard = cards
    port, jax_ = OnnxTracker(card, device="cpu"), JaxTracker(jcard)
    base = np.array([[200.0, 120.0], [320.0, 260.0], [430.0, 380.0]])
    for s in range(4):
        truth = base + np.array([9.0, -4.0]) * s
        frame = render_dots((640, 480), truth)
        got, want = port.get_points(frame, cam_id=1), jax_.get_points(frame, cam_id=1)
        np.testing.assert_array_equal(got.keypoint_id, want.keypoint_id)
        np.testing.assert_allclose(got.img_loc, want.img_loc, atol=0.05, rtol=0)
        np.testing.assert_allclose(got.confidence, want.confidence, atol=1e-5, rtol=0)
        assert sorted(got.keypoint_id.tolist()) == [0, 1, 2]
        assert np.linalg.norm(got.img_loc[np.argsort(got.keypoint_id)] - truth, axis=1).max() < 4.0
    assert port.get_point_name(2) == "foot" and port.get_point_name(9) == "kp_9"
    assert port.name == jax_.name == "BLOB3"
    rotated = port.get_points(np.rot90(render_dots((640, 480), base)).copy(), cam_id=2, rotation_count=1)
    want = jax_.get_points(np.rot90(render_dots((640, 480), base)).copy(), cam_id=2, rotation_count=1)
    np.testing.assert_allclose(rotated.img_loc, want.img_loc, atol=0.05, rtol=0)


def test_create_inference_session_refuses_missing_ops_and_other_engines(tmp_path, cards):
    card, _ = cards
    b = GraphBuilder("x", (2, 2))
    model = b.finish([b.node("NonMaxSuppression", ["x"])[0]])
    save_model(model, tmp_path / "weird.onnx")
    with pytest.raises(CalibrationError, match="NonMaxSuppression"):
        create_inference_session(tmp_path / "weird.onnx", device="cpu")
    with pytest.raises(CalibrationError, match="torch"):
        create_inference_session(card.model_path, engine="ort", device="cpu")
    missing = ModelCard.from_toml(card.model_path.with_suffix(".toml"), models_dir=tmp_path)
    with pytest.raises(CalibrationError, match="Model file not found"):
        OnnxTracker(missing, device="cpu")


def test_model_cards_and_registry_match_the_jax_package():
    from pathlib import Path

    import caliscope_tpu.pose as jpose

    import caliscope_tpu_torch.pose as tpose

    jdir = Path(jpose.__file__).parent / "model_cards"
    tdir = Path(tpose.__file__).parent / "model_cards"
    assert sorted(p.name for p in tdir.glob("*.toml")) == sorted(p.name for p in jdir.glob("*.toml"))
    for p in jdir.glob("*.toml"):
        assert (tdir / p.name).read_bytes() == p.read_bytes()
    assert TREG.available_trackers() == JREG.available_trackers()
    found, jfound = TREG.scan_onnx_models(tdir), JREG.scan_onnx_models(jdir)
    assert sorted(found) == sorted(jfound)
    for key, jc in jfound.items():
        assert found[key].to_toml_dict() == jc.to_toml_dict()
    assert TREG.available_trackers() == JREG.available_trackers()
    assert "RTMPOSE_M_HALPE26" in TREG.available_trackers()
    with pytest.raises(KeyError, match="Unknown tracker"):
        TREG.tracker_factory("nope")


# ---------------------------------------------------------------------------
# The chain, frames to a TRC file
# ---------------------------------------------------------------------------


def test_markerless_chain_from_frames_to_a_trc_file():
    """chip_smoke.py's (d) on the CPU: 4 cameras x 80 frames through
    OnnxTracker, the markerless calibrate_extrinsics and reconstruct_xyz;
    it fails unless every camera is posed, the median joint error is under
    2 cm and the TRC holds every triangulated frame. The 'auto' policy
    solves the chain's 240 points densely, so no Schur solve runs."""
    import chip_smoke

    assert chip_smoke.blob_chain(torch.device("cpu")) == 0
