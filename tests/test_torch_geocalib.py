"""The port's GeoCalib perspective-field network
(caliscope_tpu_torch/estimators/geocalib_arch.py) held against the JAX
package's copy:

- the "nano" variant (the tiny variant's op graph at test widths) with
  seeded random weights and randomized BN statistics: its state_dict()
  carries into the port's class exactly (convert.geocalib), and both
  packages' exporters write the same ONNX bytes at (160, 224);
- those bytes through the port's OnnxTorchSession against the JAX
  package's OnnxJaxSession in float32, and against the module's own
  forward, each within 1e-5 (the op-level bound of tests/test_torch_onnx.py;
  seen: 4.5e-7);
- the tiny variant's shape contract at the preprocessing geometry (short
  side 320, edges multiples of 32; tests/test_geocalib_arch.py:41-60).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from caliscope_tpu.estimators.geocalib_arch import GeoCalibFields as JaxFields
from caliscope_tpu.pose import onnx_proto as JPR
from caliscope_tpu.pose.onnx_jax import OnnxJaxSession

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.estimators.geocalib_arch import GeoCalibFields
from caliscope_tpu_torch.estimators.vertical import EDGE_MULTIPLE, FIELD_NAMES, NET_SHORT_SIDE
from caliscope_tpu_torch.pose import onnx_proto as TPR
from caliscope_tpu_torch.pose.onnx_torch import OnnxTorchSession
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NANO_HW = (160, 224)
TOL = 1e-5


def randomized_bn(model):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return model


@pytest.fixture(scope="module")
def nano():
    """(the JAX package's module, the port's with its weights, the JAX
    package's exported bytes)."""
    torch.manual_seed(11)
    jax_net = randomized_bn(JaxFields(variant="nano", decoder_width=24).eval())
    port_net = convert.geocalib(jax_net.state_dict(), "nano", 24)
    return jax_net, port_net, JPR.write_model(jax_net.export_onnx_model(input_hw=NANO_HW))


def test_weights_carry_across_exactly(nano):
    jax_net, port_net, _ = nano
    want, got = jax_net.state_dict(), port_net.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_exports_give_the_same_bytes(nano):
    _, port_net, data = nano
    assert TPR.write_model(port_net.export_onnx_model(input_hw=NANO_HW)) == data
    assert TPR.write_model(TPR.parse_model(data)) == data


def test_port_session_matches_jax_session_and_module(nano):
    _, port_net, data = nano
    x = np.random.default_rng(3).normal(size=(1, 3, *NANO_HW)).astype(np.float32)
    sess = OnnxTorchSession(TPR.parse_model(data), device="cpu")
    assert [o.name for o in sess.get_outputs()] == list(FIELD_NAMES)
    got = sess.run(None, {"input": x})
    want = OnnxJaxSession(JPR.parse_model(data)).run(None, {"input": x})
    with torch.no_grad():
        module = [t.numpy() for t in port_net(torch.as_tensor(x))]
    for name, g, w, m in zip(FIELD_NAMES, got, want, module):
        assert g.shape == np.asarray(w).shape == m.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(g, m, rtol=TOL, atol=TOL, err_msg=name)


def test_tiny_variant_shape_contract():
    torch.manual_seed(0)
    net = GeoCalibFields(variant="tiny").eval()
    h, w = NET_SHORT_SIDE, NET_SHORT_SIDE + EDGE_MULTIPLE
    with torch.no_grad():
        up, up_conf, lat, lat_conf = net(torch.randn(1, 3, h, w))
    assert up.shape == (1, 2, h, w)
    assert up_conf.shape == lat.shape == lat_conf.shape == (1, 1, h, w)
    np.testing.assert_allclose(np.linalg.norm(up.numpy(), axis=1), 1.0, atol=1e-5)  # unit up field
    assert float(lat.abs().max()) <= np.pi / 2 + 1e-6
    assert 0.0 <= float(up_conf.min()) and float(up_conf.max()) <= 1.0


@pytest.mark.cuda
def test_tiny_through_the_executor_on_cuda():
    """The tiny variant at the 16:9 geometry (320, 576) on the card: the
    executor within the pose phase's bound of the module's forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    torch.manual_seed(0)
    net = randomized_bn(GeoCalibFields(variant="tiny").eval()).cuda()
    sess = OnnxTorchSession(TPR.parse_model(TPR.write_model(net.export_onnx_model((320, 576)))), device="cuda")
    x = torch.randn(1, 3, 320, 576, device="cuda")
    with torch.no_grad():
        want = net(x)
    for g, w in zip(sess.forward({"input": x}), want):
        assert torch.allclose(g, w, atol=2e-3, rtol=1e-3)
