"""Minimal torch -> ONNX exporter for feed-forward CNNs.

Copy of caliscope_tpu/pose/torch_onnx.py. torch.onnx.export needs the
`onnx`/`onnxscript` packages, which neither machine ships; this exporter
walks a restricted module family (Sequential-style backbones + multi-head
wrappers, and composite modules with an `export_onnx(builder, x)` method)
and emits the graph through the first-party writer (pose/onnx_proto.py).
Weights are read from wherever the module lives (copied to the host).
Unsupported modules fail loudly.
"""

from __future__ import annotations

import numpy as np

from caliscope_tpu_torch.pose.onnx_proto import OnnxGraph, OnnxModel, OnnxNode


class GraphBuilder:
    """Incremental ONNX graph builder with unique tensor naming."""

    def __init__(self, input_name: str = "input", input_shape=None):
        self.graph = OnnxGraph(name="caliscope_export")
        self.graph.inputs = [input_name]
        self.graph.input_shapes[input_name] = tuple(input_shape) if input_shape else None
        self._n = 0

    def _name(self, op: str) -> str:
        self._n += 1
        return f"{op.lower()}_{self._n}"

    def init(self, arr: np.ndarray, hint: str = "w") -> str:
        name = f"{hint}_{self._n}_{len(self.graph.initializers)}"
        self.graph.initializers[name] = np.asarray(arr)
        return name

    def node(self, op: str, inputs: list[str], n_out: int = 1, **attrs) -> list[str]:
        outs = [self._name(op) for _ in range(n_out)]
        self.graph.nodes.append(OnnxNode(op_type=op, inputs=list(inputs), outputs=outs, attrs=attrs))
        return outs

    def finish(self, outputs: list[str]) -> OnnxModel:
        self.graph.outputs = list(outputs)
        return OnnxModel(graph=self.graph)


def _export_module(b: GraphBuilder, module, x: str) -> str:
    """Append `module`'s ops reading tensor `x`; returns the output name.

    Composite modules may implement their own export via the
    `export_onnx(builder, x) -> out_name` protocol (used by the RTMPose
    architecture family in pose/rtmpose_arch.py — residual adds, CSP
    splits, attention blocks don't fit the Sequential walk)."""
    import torch.nn as nn

    if hasattr(module, "export_onnx") and not isinstance(module, nn.Sequential):
        return module.export_onnx(b, x)
    if isinstance(module, nn.Sequential):
        for child in module:
            x = _export_module(b, child, x)
        return x
    if isinstance(module, nn.Conv2d):
        w = b.init(module.weight.detach().cpu().numpy(), "conv_w")
        inputs = [x, w]
        if module.bias is not None:
            inputs.append(b.init(module.bias.detach().cpu().numpy(), "conv_b"))
        return b.node(
            "Conv", inputs,
            kernel_shape=list(module.kernel_size), strides=list(module.stride),
            pads=[module.padding[0], module.padding[1], module.padding[0], module.padding[1]],
            dilations=list(module.dilation), group=module.groups,
        )[0]
    if isinstance(module, nn.ConvTranspose2d):
        w = b.init(module.weight.detach().cpu().numpy(), "convt_w")
        inputs = [x, w]
        if module.bias is not None:
            inputs.append(b.init(module.bias.detach().cpu().numpy(), "convt_b"))
        return b.node(
            "ConvTranspose", inputs,
            kernel_shape=list(module.kernel_size), strides=list(module.stride),
            pads=[module.padding[0], module.padding[1], module.padding[0], module.padding[1]],
        )[0]
    if isinstance(module, nn.BatchNorm2d):
        return b.node(
            "BatchNormalization",
            [
                x,
                b.init(module.weight.detach().cpu().numpy(), "bn_s"),
                b.init(module.bias.detach().cpu().numpy(), "bn_b"),
                b.init(module.running_mean.detach().cpu().numpy(), "bn_m"),
                b.init(module.running_var.detach().cpu().numpy(), "bn_v"),
            ],
            epsilon=float(module.eps),
        )[0]
    if isinstance(module, nn.Linear):
        w = b.init(module.weight.detach().cpu().numpy(), "fc_w")
        inputs = [x, w]
        if module.bias is not None:
            inputs.append(b.init(module.bias.detach().cpu().numpy(), "fc_b"))
        return b.node("Gemm", inputs, transB=1)[0]
    if isinstance(module, nn.ReLU):
        return b.node("Relu", [x])[0]
    if isinstance(module, nn.SiLU):
        s = b.node("Sigmoid", [x])[0]
        return b.node("Mul", [x, s])[0]
    if isinstance(module, nn.Sigmoid):
        return b.node("Sigmoid", [x])[0]
    if isinstance(module, nn.Tanh):
        return b.node("Tanh", [x])[0]
    if isinstance(module, nn.LeakyReLU):
        return b.node("LeakyRelu", [x], alpha=float(module.negative_slope))[0]
    if isinstance(module, nn.MaxPool2d):
        k = module.kernel_size if isinstance(module.kernel_size, (list, tuple)) else (module.kernel_size,) * 2
        s = module.stride if isinstance(module.stride, (list, tuple)) else (module.stride or k[0],) * 2
        p = module.padding if isinstance(module.padding, (list, tuple)) else (module.padding,) * 2
        return b.node(
            "MaxPool", [x], kernel_shape=list(k), strides=list(s), pads=[p[0], p[1], p[0], p[1]]
        )[0]
    if isinstance(module, nn.AdaptiveAvgPool2d):
        assert module.output_size in (1, (1, 1)), "only global average pool supported"
        return b.node("GlobalAveragePool", [x])[0]
    if isinstance(module, nn.Upsample):
        assert module.scale_factor is not None
        sf = module.scale_factor if isinstance(module.scale_factor, (list, tuple)) else (module.scale_factor,) * 2
        scales = b.init(np.asarray([1.0, 1.0, float(sf[0]), float(sf[1])], np.float32), "resize_s")
        mode = {"nearest": "nearest", "bilinear": "linear"}[module.mode]
        return b.node("Resize", [x, "", scales], mode=mode)[0]
    if isinstance(module, nn.Flatten):
        return b.node("Flatten", [x], axis=int(module.start_dim))[0]
    if isinstance(module, nn.Softmax):
        return b.node("Softmax", [x], axis=int(module.dim))[0]
    if isinstance(module, nn.Identity):
        return x
    raise NotImplementedError(f"torch module {type(module).__name__} is not supported by the minimal exporter")


def export_feedforward(module, input_shape, heads=None) -> OnnxModel:
    """Export a Sequential-style torch module (optionally with named head
    submodules reading the trunk output) to an OnnxModel.

    heads: optional dict name -> submodule; each becomes a graph output.
    Without heads, the trunk output is the single graph output.
    """
    b = GraphBuilder("input", input_shape)
    trunk_out = _export_module(b, module, "input")
    if not heads:
        return b.finish([trunk_out])
    outs = []
    for head_name, head in heads.items():
        out = _export_module(b, head, trunk_out)
        # alias the head output to a stable name via Identity
        named = b.node("Identity", [out])[0]
        self_idx = b.graph.nodes[-1]
        self_idx.outputs = [head_name]
        outs.append(head_name)
    return b.finish(outs)
