"""The port's ONNX stack (caliscope_tpu_torch/pose/: onnx_proto, torch_onnx,
rtmpose_arch, onnx_torch, decode) held against the JAX package's.

- The writer: the port's and the JAX package's give the same bytes for the
  same graph, and a JAX-written file re-parsed by the port is re-written
  byte for byte.
- The executor: OnnxTorchSession against OnnxJaxSession on every op case of
  tests/test_onnx_engine.py (TestExecutorVsTorch, TestExecutorOpCoverage)
  and on the ops and attributes those leave out, within 1e-5 in float32
  (both run the same float32 graph; they differ by summation order); the
  two executors implement the same set of ops.
- RTMPose-t at a reduced input the architecture accepts (128 x 96, each
  side a multiple of 32), exported, serialized and re-parsed: the port's
  session within 1e-5 of the module's own eval forward (seen: ~1e-6), and
  within the JAX suite's bound (atol 2e-3, rtol 1e-3,
  tests/test_rtmpose_arch.py) of OnnxJaxSession, run once per test run.
- The decoders: argmax ids equal (ties to the first index), coordinates
  within 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn as nn

from caliscope_tpu.pose import decode as JD
from caliscope_tpu.pose import onnx_proto as JPR
from caliscope_tpu.pose import rtmpose_arch as JR
from caliscope_tpu.pose.onnx_jax import OnnxJaxSession, _Executor as JaxExecutor
from caliscope_tpu.pose.torch_onnx import GraphBuilder as JaxBuilder
from caliscope_tpu.pose.torch_onnx import export_feedforward as jax_export

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.pose import decode as TD
from caliscope_tpu_torch.pose import onnx_proto as TPR
from caliscope_tpu_torch.pose.onnx_torch import OnnxTorchSession, _Executor as PortExecutor
from caliscope_tpu_torch.pose.rtmpose_arch import RTMPose
from caliscope_tpu_torch.pose.torch_onnx import GraphBuilder, export_feedforward
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OP_TOL = 1e-5
ARCH_HW = (128, 96)


def run_both(jax_model, feeds):
    """(port outputs, JAX outputs) of one JAX-built model, the port's copy
    parsed from the JAX writer's bytes."""
    port_model = convert.onnx_model(JPR.write_model(jax_model))
    got = OnnxTorchSession(port_model, device="cpu").run(None, feeds)
    want = OnnxJaxSession(jax_model).run(None, feeds)
    return got, want


def assert_same(got, want, tol=OP_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# The wire format
# ---------------------------------------------------------------------------


def small_graph(builder_cls):
    rng = np.random.default_rng(0)
    b = builder_cls("x", (1, 3, 8, 8))
    w = b.init(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    out = b.node("Conv", ["x", w], kernel_shape=[3, 3], strides=[1, 1], pads=[1, 1, 1, 1])[0]
    ax = b.init(np.asarray([-1], np.int64), "axes")
    red = b.node("ReduceMean", [out, ax], keepdims=0)[0]
    cl = b.node("Clip", [red], min=-0.5, max=0.5)[0]
    b.node("Resize", [cl, "", b.init(np.asarray([1.0, 1.0, 2.0], np.float32), "s")], mode="linear")
    b.node("Split", [cl], n_out=2, axis=-1, split=[3, 5])
    b.node("Constant", [], value=np.arange(4, dtype=np.int32), value_floats=[0.5, 1.5], names=["a", "b"])
    return b.finish([b.graph.nodes[3].outputs[0], b.graph.nodes[4].outputs[1]])


def test_writers_give_the_same_bytes():
    data = JPR.write_model(small_graph(JaxBuilder))
    assert TPR.write_model(small_graph(GraphBuilder)) == data
    back = TPR.parse_model(data)
    assert TPR.write_model(back) == data
    assert [n.op_type for n in back.graph.nodes] == [n.op_type for n in JPR.parse_model(data).graph.nodes]
    assert back.graph.input_shapes["x"] == (1, 3, 8, 8)
    assert back.graph.nodes[1].attrs["keepdims"] == 0
    np.testing.assert_array_equal(back.graph.initializers["axes_1_1"], [-1])


def test_rtmpose_files_round_trip_byte_for_byte(rtmpose):
    jax_model, port_model, _ = rtmpose
    data = JPR.write_model(jax_model.export_onnx_model())
    assert TPR.write_model(port_model.export_onnx_model()) == data
    assert TPR.write_model(TPR.parse_model(data)) == data


# ---------------------------------------------------------------------------
# The executor, op by op
# ---------------------------------------------------------------------------


def test_the_executors_implement_the_same_ops():
    ops = lambda cls: sorted(n[3:] for n in dir(cls) if n.startswith("op_"))  # noqa: E731
    assert ops(PortExecutor) == ops(JaxExecutor)
    assert len(ops(PortExecutor)) == 45


def torch_cases():
    """The module stacks of TestExecutorVsTorch, with their input shapes."""
    torch.manual_seed(0)
    m1 = nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.BatchNorm2d(8), nn.SiLU(),
        nn.Conv2d(8, 8, 3, padding=1, groups=2), nn.LeakyReLU(0.1),
    )
    m1[1].running_mean.normal_()
    m1[1].running_var.uniform_(0.5, 2.0)
    torch.manual_seed(1)
    m2 = nn.Sequential(
        nn.Conv2d(3, 6, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2, 2), nn.AdaptiveAvgPool2d(1),
        nn.Flatten(), nn.Linear(6, 10), nn.Softmax(dim=-1),
    )
    torch.manual_seed(2)
    m3 = nn.Sequential(
        nn.Conv2d(3, 4, 3, stride=2, padding=1), nn.Upsample(scale_factor=2.0, mode="bilinear"),
        nn.ConvTranspose2d(4, 2, 4, stride=2, padding=1), nn.Tanh(),
    )
    return {"conv_bn_silu": (m1, (2, 3, 16, 20)), "pool_fc_softmax": (m2, (3, 3, 12, 12)),
            "upsample_transposed_conv": (m3, (1, 3, 10, 14))}


@pytest.mark.parametrize("case", ["conv_bn_silu", "pool_fc_softmax", "upsample_transposed_conv"])
def test_module_stacks_match_jax(case):
    module, shape = torch_cases()[case]
    x = np.random.default_rng(len(case)).normal(size=shape).astype(np.float32)
    got, want = run_both(jax_export(module.eval(), shape), {"input": x})
    assert_same(got, want)
    port = OnnxTorchSession(export_feedforward(module, shape), device="cpu").run(None, {"input": x})
    assert_same(port, want)


def graph_cases():
    """name -> (JAX-built model, feeds): the graphs of TestExecutorOpCoverage
    and the shape-plumbing case, and the ops and attributes they leave out."""
    rng = np.random.default_rng(3)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
    cases = {}

    b = JaxBuilder("x", (2, 3, 4, 5))
    shp = b.node("Shape", ["x"])[0]
    n = b.node("Gather", [shp, b.init(i64(0), "zero")], axis=0)[0]
    target = b.node("Concat", [n, b.init(i64(-1), "tail")], axis=0)[0]
    cases["shape_plumbing"] = (b.finish([b.node("Reshape", ["x", target])[0]]), {"x": f32(2, 3, 4, 5)})

    b = JaxBuilder("x", (2, 3, 6))
    sl = b.node("Slice", ["x", b.init(i64(1), "st"), b.init(i64(5), "en"), b.init(i64(2), "ax")])[0]
    cases["slice_pad"] = (b.finish([b.node("Pad", [sl, b.init(i64(0, 0, 1, 0, 0, 1), "pads")])[0]]),
                          {"x": np.arange(36, dtype=np.float32).reshape(2, 3, 6)})

    b = JaxBuilder("x", (2, 1, 4))
    sq = b.node("Squeeze", ["x", b.init(i64(1), "ax1")])[0]
    un = b.node("Unsqueeze", [sq, b.init(i64(0), "ax0")])[0]
    cc = b.node("Concat", [un, un], axis=0)[0]
    cases["squeeze_unsqueeze_concat_gather"] = (
        b.finish([b.node("Gather", [cc, b.init(i64(1), "idx")], axis=0)[0]]), {"x": f32(2, 1, 4)})

    for op, attrs in (("HardSigmoid", {}), ("HardSwish", {}), ("Erf", {}), ("Exp", {}), ("Sigmoid", {}),
                      ("Tanh", {}), ("Relu", {}), ("Neg", {}), ("Identity", {}), ("LeakyRelu", {"alpha": 0.2}),
                      ("Softmax", {"axis": 0}), ("HardSigmoid", {"alpha": 0.3, "beta": 0.4})):
        b = JaxBuilder("x", (2, 8))
        cases[f"act_{op}_{len(attrs)}"] = (b.finish([b.node(op, ["x"], **attrs)[0]]), {"x": f32(2, 8)})

    ln_w, ln_b = f32(10), f32(10)
    b = JaxBuilder("x", (4, 10))
    out = b.node("LayerNormalization", ["x", b.init(ln_w, "s"), b.init(ln_b, "b")], axis=-1, epsilon=1e-5)[0]
    red = b.node("ReduceMax", [out, b.init(i64(1), "ax")], keepdims=0)[0]
    cases["layernorm_reduce"] = (b.finish([out, red]), {"x": f32(4, 10)})

    b = JaxBuilder("x", (3,))
    c = b.node("ConstantOfShape", [b.init(i64(3), "shp")], value=np.asarray([2.5], np.float32))[0]
    cl = b.node("Clip", ["x", b.init(np.asarray(-1.0, np.float32), "lo"), b.init(np.asarray(1.0, np.float32), "hi")])[0]
    cases["clip_constantofshape"] = (b.finish([b.node("Add", [cl, c])[0]]),
                                     {"x": np.asarray([-5.0, 0.0, 5.0], np.float32)})

    # ops and attributes the JAX suite's cases leave out
    b = JaxBuilder("x", (3, 4))
    g = b.node("Gemm", ["x", b.init(f32(5, 4), "a_w"), b.init(f32(5), "a_c")], transA=1, transB=1, alpha=0.5, beta=2.0)
    sub = b.node("Sub", [g[0], b.init(f32(5), "o")])[0]
    div = b.node("Div", [sub, b.init(np.asarray(3.0, np.float32), "d")])[0]
    pw = b.node("Pow", [b.node("Relu", [div])[0], b.init(np.asarray(2.0, np.float32), "p")])[0]
    sq = b.node("Sqrt", [b.node("Add", [pw, b.init(np.asarray(1.0, np.float32), "one")])[0]])[0]
    cases["gemm_arith"] = (b.finish([sq, b.node("Clip", [div], min=-0.1)[0]]), {"x": f32(4, 3)})

    b = JaxBuilder("x", (2, 3, 9, 11))
    mp = b.node("MaxPool", ["x"], kernel_shape=[3, 2], strides=[2, 2], pads=[1, 0, 0, 1])[0]
    mp2 = b.node("MaxPool", ["x"], kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER")[0]
    ap = b.node("AveragePool", ["x"], kernel_shape=[3, 3], strides=[2, 1], pads=[1, 1, 1, 1])[0]
    gap = b.node("GlobalAveragePool", ["x"])[0]
    cv = b.node("Conv", ["x", b.init(f32(4, 3, 3, 2), "cw")], strides=[2, 3], auto_pad="SAME_LOWER", dilations=[1, 1])[0]
    cv2 = b.node("Conv", ["x", b.init(f32(6, 1, 5, 5), "dw"), b.init(f32(6), "db")], kernel_shape=[5, 5],
                 pads=[2, 1, 2, 3], group=3)[0]
    cv3 = b.node("Conv", ["x", b.init(f32(2, 3, 3, 3), "dl")], pads=[2, 2, 2, 2], dilations=[2, 2])[0]
    cases["pool_conv_pads"] = (b.finish([mp, mp2, ap, gap, cv, cv2, cv3]), {"x": f32(2, 3, 9, 11)})

    b = JaxBuilder("x", (1, 2, 5, 7))
    ct = b.node("ConvTranspose", ["x", b.init(f32(2, 3, 3, 4), "tw"), b.init(f32(3), "tb")], strides=[2, 3],
                pads=[1, 0, 0, 2], output_padding=[1, 2])[0]
    cases["conv_transpose_pads"] = (b.finish([ct]), {"x": f32(1, 2, 5, 7)})

    b = JaxBuilder("x", (1, 2, 12, 10))
    outs = [
        b.node("Resize", ["x", "", b.init(np.asarray([1, 1, 0.5, 0.6], np.float32), "s1")], mode="linear")[0],
        b.node("Resize", ["x", "", b.init(np.asarray([1, 1, 1.5, 2.0], np.float32), "s2")], mode="cubic")[0],
        b.node("Resize", ["x", "", "", b.init(i64(1, 2, 5, 17), "sz")], mode="nearest")[0],
        b.node("Resize", ["x", "", b.init(np.asarray([1, 1, 0.25, 0.3], np.float32), "s3")], mode="cubic")[0],
    ]
    cases["resize_modes"] = (b.finish(outs), {"x": f32(1, 2, 12, 10)})

    b = JaxBuilder("x", (2, 6, 4))
    cast = b.node("Cast", [b.node("Shape", ["x"])[0]], to=1)[0]
    kst = b.node("Constant", [], value=np.arange(1, 7, dtype=np.float32).reshape(6, 1))[0]
    flat = b.node("Flatten", ["x"], axis=2)[0]
    tr = b.node("Transpose", ["x"], perm=[2, 0, 1])[0]
    trd = b.node("Transpose", ["x"])[0]
    s1, s2, s3 = b.node("Split", ["x"], n_out=3, axis=1, num_outputs=3)
    rev = b.node("Slice", ["x", b.init(i64(-1, 3), "rs"), b.init(i64(-2**31, 0), "re"), b.init(i64(1, 2), "ra"),
                           b.init(i64(-2, -1), "rst")])[0]
    gneg = b.node("Gather", ["x", b.init(np.asarray([[-1, 0], [2, 1]], np.int64), "gi")], axis=-1)[0]
    sq_all = b.node("Squeeze", [b.node("Unsqueeze", ["x", b.init(i64(0, -1), "ua")])[0]])[0]
    ex = b.node("Expand", [b.node("Mul", ["x", kst])[0], b.init(i64(3, 2, 6, 1), "es")])[0]
    pv = b.node("Pad", ["x", b.init(i64(1, 0, 2, 0, 1, 1), "pp"), b.init(np.asarray([7.5], np.float32), "pv")])[0]
    rm = b.node("ReduceMean", ["x"], keepdims=1)[0]
    cases["plumbing"] = (b.finish([cast, flat, tr, trd, s1, s3, rev, gneg, sq_all, ex, pv, rm]),
                         {"x": f32(2, 6, 4)})
    return cases


GRAPH_CASES = sorted(graph_cases())


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_op_cases_match_jax(case):
    model, feeds = graph_cases()[case]
    got, want = run_both(model, feeds)
    assert_same(got, want)


def test_folded_shape_arithmetic_stays_on_the_host():
    """Shape -> Gather -> Concat is numpy: the Reshape target is a host
    constant, never a device tensor."""
    model, feeds = graph_cases()["shape_plumbing"]
    ex = PortExecutor(convert.onnx_model(JPR.write_model(model)).graph, torch.device("cpu"))
    seen = {}
    reshape = ex.op_Reshape

    def spy(attrs, x, shape):
        seen["shape"] = shape
        return reshape(attrs, x, shape)

    ex.op_Reshape = spy
    ex._ops = [(spy if fn.__name__ == "op_Reshape" else fn, node) for fn, node in ex._ops]
    ex({"x": torch.as_tensor(feeds["x"])})
    assert isinstance(seen["shape"], np.ndarray)
    np.testing.assert_array_equal(seen["shape"], [2, -1])


def test_an_unimplemented_op_is_refused_at_construction():
    b = GraphBuilder("x", (2, 2))
    model = b.finish([b.node("NonMaxSuppression", ["x"])[0]])
    with pytest.raises(NotImplementedError, match="NonMaxSuppression"):
        OnnxTorchSession(model, device="cpu")


# ---------------------------------------------------------------------------
# RTMPose-t end to end
# ---------------------------------------------------------------------------


def randomized_bn(model):
    """BN with random running statistics (fresh modules have mean 0 / var 1,
    which would hide normalization faults), as tests/test_rtmpose_arch.py."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return model


@pytest.fixture(scope="module")
def rtmpose(tmp_path_factory):
    """(JAX package's RTMPose-t, the port's copy with its weights, the JAX
    executor's outputs on the test input), the JAX run once per test run."""
    from tests.fixture_cache import per_run_cached

    torch.manual_seed(7)
    jax_model = randomized_bn(JR.RTMPose(variant="t", n_keypoints=17, input_hw=ARCH_HW).eval())
    port_model = convert.rtmpose(jax_model.state_dict(), "t", 17, ARCH_HW)
    x = rtmpose_input()

    def compute():
        return OnnxJaxSession(JPR.parse_model(JPR.write_model(jax_model.export_onnx_model()))).run(
            None, {"input": x})

    return jax_model, port_model, per_run_cached(tmp_path_factory, "torch_onnx_rtmpose_t", compute)


def rtmpose_input():
    return np.random.default_rng(11).normal(size=(2, 3, *ARCH_HW)).astype(np.float32)


def test_rtmpose_t_through_the_port_session(rtmpose):
    """The port's session on the re-parsed bytes: within 1e-5 of the
    module's eval forward, within the JAX suite's bound of OnnxJaxSession;
    the output contract of the SimCC cards; the decoded keypoints agree."""
    _, port_model, (jx, jy) = rtmpose
    x = rtmpose_input()
    raw = TPR.write_model(port_model.export_onnx_model())
    sess = OnnxTorchSession(TPR.parse_model(raw), device="cpu")
    assert [o.name for o in sess.get_outputs()] == ["simcc_x", "simcc_y"]
    gx, gy = sess.run(None, {"input": x})
    assert gx.shape == (2, 17, ARCH_HW[1] * 2) and gy.shape == (2, 17, ARCH_HW[0] * 2)
    with torch.no_grad():
        tx, ty = (t.numpy() for t in port_model(torch.as_tensor(x)))
    np.testing.assert_allclose(gx, tx, atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(gy, ty, atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(gx, jx, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(gy, jy, atol=2e-3, rtol=1e-3)
    kp_port, _ = TD.decode_simcc(torch.as_tensor(gx), torch.as_tensor(gy))
    kp_jax, _ = JD.decode_simcc(jx, jy)
    np.testing.assert_allclose(kp_port.numpy(), np.asarray(kp_jax), atol=0.51)


def test_rtmpose_weights_carry_across_exactly(rtmpose):
    jax_model, port_model, _ = rtmpose
    x = torch.as_tensor(rtmpose_input())
    with torch.no_grad():
        for a, b in zip(jax_model(x), port_model(x)):
            assert torch.equal(a, b)
    ops = {n.op_type for n in port_model.export_onnx_model().graph.nodes}
    assert {"Conv", "BatchNormalization", "MaxPool", "GlobalAveragePool", "HardSigmoid", "Split", "MatMul",
            "ReduceMean", "Clip"} <= ops


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def simcc_logits(seed: int):
    """SimCC vectors with ties (two equal maxima), peaks at both borders and
    negative peaks (confidence clipped to 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 40)).astype(np.float32)
    y = rng.normal(size=(3, 5, 56)).astype(np.float32)
    x[0, 0, [7, 30]] = 9.0
    x[0, 1, 0] = 9.0
    x[0, 2, -1] = 9.0
    y[1, 3, [0, 1]] = 9.0
    x[2] -= 20.0
    return x, y


@pytest.mark.parametrize("refine", [True, False])
def test_decode_simcc_matches_jax(refine):
    x, y = simcc_logits(0)
    kp, conf = TD.decode_simcc(torch.as_tensor(x), torch.as_tensor(y), refine=refine)
    jkp, jconf = JD.decode_simcc(x, y, refine=refine)
    if refine:
        np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), atol=1e-5, rtol=0)
    else:  # the argmax ids themselves, halved by the split ratio
        np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=1e-6, rtol=0)
    assert kp.dtype == torch.float32


@pytest.mark.parametrize("refine", [True, False])
def test_decode_heatmap_matches_jax(refine):
    rng = np.random.default_rng(1)
    hm = rng.uniform(size=(2, 4, 9, 13)).astype(np.float32)
    hm[0, 0, 3, 4] = hm[0, 0, 6, 2] = 5.0  # a tie: the first in row-major order
    hm[0, 1, 0, 5] = 5.0  # border peaks: no refinement
    hm[1, 2, 8, 12] = 5.0
    hm[1, 3, 4, 6] = 5.0
    hm[1, 3, 4, 7] = 5.0 - 1e-3
    kp, conf = TD.decode_heatmap(torch.as_tensor(hm), refine=refine)
    jkp, jconf = JD.decode_heatmap(hm, refine=refine)
    if refine:
        np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), atol=1e-5, rtol=0)
    else:  # the argmax ids themselves
        np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=0, rtol=0)


@pytest.mark.cuda
def test_rtmpose_t_on_the_card_matches_the_module():
    """RTMPose-t at its full 256 x 192 input through OnnxTorchSession on the
    card, against the module's own eval forward on the card, within the JAX
    suite's bound (atol 2e-3, rtol 1e-3); the decoded keypoints agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(7)
    model = randomized_bn(RTMPose(variant="t", n_keypoints=17, input_hw=(256, 192)).eval()).cuda()
    sess = OnnxTorchSession(TPR.parse_model(TPR.write_model(model.export_onnx_model())))
    x = torch.randn(2, 3, 256, 192, device="cuda")
    with torch.no_grad():
        want = model(x)
    got = sess.forward({"input": x})
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-3)
    kg, _ = TD.decode_simcc(*got)
    kw, _ = TD.decode_simcc(*want)
    assert float((kg - kw).abs().max()) <= 0.51
