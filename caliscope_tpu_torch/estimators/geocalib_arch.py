"""The GeoCalib perspective-field network in torch, with first-party ONNX
export.

The port's own copy of caliscope_tpu/estimators/geocalib_arch.py (the
architecture behind the vertical estimator's model spec: the GeoCalib
perspective-field export, Veicht et al., ECCV 2024), built layer for layer
with the same class and parameter names, so a JAX-package module's
state_dict() loads unchanged (convert.geocalib):

- MSCAN encoder (SegNeXt's backbone): two-conv BN+GELU stem, overlapping
  patch embeddings, and blocks of [BN -> 1x1 proj -> GELU -> multi-scale
  strip attention (5x5 depthwise + 1x7/7x1 + 1x11/11x1 + 1x21/21x1
  depthwise strip pairs, 1x1 mix, multiplicative gate) -> 1x1 proj] and
  [BN -> 1x1 -> depthwise 3x3 -> GELU -> 1x1] MLPs, each residual with
  per-channel layer scales.
- A light FPN decoder (1x1 laterals to a shared width, top-down bilinear
  upsample + add, 3x3 smoothing). It pins the structure class and the
  executor-facing output contract, not a checkpoint's layout.
- Field heads emitting the four outputs of estimators/vertical.py's
  FIELD_NAMES in that order: up_field (2ch, L2-normalized per pixel),
  up_confidence (1ch, sigmoid), latitude_field (1ch, tanh-bounded),
  latitude_confidence (1ch, sigmoid), all at the network input resolution
  (short side 320, edges multiples of 32).

Weights are random until a checkpoint is in the repository; the op graph is
what this module pins down. Every composite block implements
`export_onnx(builder, x)` (torch_onnx.py's protocol hook), so the model
exports through the first-party writer, byte for byte as the JAX package's
copy exports the same weights, and runs through pose/onnx_torch.py's
OnnxTorchSession. Export reads the weights from wherever the module lives.
"""

from __future__ import annotations

import numpy as np

import torch
import torch.nn as nn

from caliscope_tpu_torch.pose.torch_onnx import GraphBuilder, _export_module


def _export_gelu(b: GraphBuilder, x: str) -> str:
    """Exact (erf) GELU: 0.5 * x * (1 + erf(x / sqrt(2)))."""
    inv = b.init(np.float32(1.0 / np.sqrt(2.0)), "gelu_inv")
    e = b.node("Erf", [b.node("Mul", [x, inv])[0]])[0]
    one = b.init(np.float32(1.0), "gelu_one")
    half = b.init(np.float32(0.5), "gelu_half")
    return b.node("Mul", [b.node("Mul", [x, b.node("Add", [e, one])[0]])[0], half])[0]


class ConvBN(nn.Module):
    """Conv + BN (+ optional exact GELU)."""

    def __init__(self, c_in, c_out, k, stride=1, padding=None, groups=1, act=False):
        super().__init__()
        if padding is None:
            padding = k // 2 if isinstance(k, int) else tuple(kk // 2 for kk in k)
        self.conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding, groups=groups)
        self.bn = nn.BatchNorm2d(c_out)
        self.act = nn.GELU() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        x = _export_module(b, self.conv, x)
        x = _export_module(b, self.bn, x)
        return _export_gelu(b, x) if self.act is not None else x


class MSCA(nn.Module):
    """Multi-scale convolutional attention (SegNeXt): 5x5 depthwise base,
    three depthwise strip-pair branches (7, 11, 21), 1x1 mix, gate."""

    def __init__(self, dim):
        super().__init__()
        self.conv0 = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv0_1 = nn.Conv2d(dim, dim, (1, 7), padding=(0, 3), groups=dim)
        self.conv0_2 = nn.Conv2d(dim, dim, (7, 1), padding=(3, 0), groups=dim)
        self.conv1_1 = nn.Conv2d(dim, dim, (1, 11), padding=(0, 5), groups=dim)
        self.conv1_2 = nn.Conv2d(dim, dim, (11, 1), padding=(5, 0), groups=dim)
        self.conv2_1 = nn.Conv2d(dim, dim, (1, 21), padding=(0, 10), groups=dim)
        self.conv2_2 = nn.Conv2d(dim, dim, (21, 1), padding=(10, 0), groups=dim)
        self.conv3 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        u = x
        attn = self.conv0(x)
        a0 = self.conv0_2(self.conv0_1(attn))
        a1 = self.conv1_2(self.conv1_1(attn))
        a2 = self.conv2_2(self.conv2_1(attn))
        attn = self.conv3(attn + a0 + a1 + a2)
        return attn * u

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        attn = _export_module(b, self.conv0, x)
        a0 = _export_module(b, self.conv0_2, _export_module(b, self.conv0_1, attn))
        a1 = _export_module(b, self.conv1_2, _export_module(b, self.conv1_1, attn))
        a2 = _export_module(b, self.conv2_2, _export_module(b, self.conv2_1, attn))
        s = b.node("Add", [b.node("Add", [b.node("Add", [attn, a0])[0], a1])[0], a2])[0]
        mixed = _export_module(b, self.conv3, s)
        return b.node("Mul", [mixed, x])[0]


class SpatialAttention(nn.Module):
    """1x1 proj -> GELU -> MSCA -> 1x1 proj (MSCAN attention branch)."""

    def __init__(self, dim):
        super().__init__()
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.act = nn.GELU()
        self.gate = MSCA(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        return self.proj_2(self.gate(self.act(self.proj_1(x))))

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        x = _export_module(b, self.proj_1, x)
        x = _export_gelu(b, x)
        x = self.gate.export_onnx(b, x)
        return _export_module(b, self.proj_2, x)


class MSCANMlp(nn.Module):
    """1x1 -> depthwise 3x3 -> GELU -> 1x1 (MSCAN's conv MLP)."""

    def __init__(self, dim, ratio=4):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dw = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(self.act(self.dw(self.fc1(x))))

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        x = _export_module(b, self.fc1, x)
        x = _export_module(b, self.dw, x)
        x = _export_gelu(b, x)
        return _export_module(b, self.fc2, x)


class MSCANBlock(nn.Module):
    """BN -> attention (+ layer-scaled residual), BN -> MLP (+ residual)."""

    def __init__(self, dim, mlp_ratio=4):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim)
        self.attn = SpatialAttention(dim)
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.norm2 = nn.BatchNorm2d(dim)
        self.mlp = MSCANMlp(dim, mlp_ratio)
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-2))

    def forward(self, x):
        x = x + self.ls1[None, :, None, None] * self.attn(self.norm1(x))
        return x + self.ls2[None, :, None, None] * self.mlp(self.norm2(x))

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        a = self.attn.export_onnx(b, _export_module(b, self.norm1, x))
        s1 = b.init(self.ls1.detach().cpu().numpy().reshape(1, -1, 1, 1).astype(np.float32), "ls1")
        x = b.node("Add", [x, b.node("Mul", [a, s1])[0]])[0]
        m = self.mlp.export_onnx(b, _export_module(b, self.norm2, x))
        s2 = b.init(self.ls2.detach().cpu().numpy().reshape(1, -1, 1, 1).astype(np.float32), "ls2")
        return b.node("Add", [x, b.node("Mul", [m, s2])[0]])[0]


class MSCAN(nn.Module):
    """SegNeXt backbone, returning all four stage feature maps.

    Real configs: tiny = dims (32, 64, 160, 256), depths (3, 3, 5, 2);
    "nano" is a test-size config with the identical op graph.
    """

    CONFIGS = {
        "tiny": ((32, 64, 160, 256), (3, 3, 5, 2)),
        "nano": ((16, 24, 32, 48), (2, 2, 2, 2)),
    }

    def __init__(self, variant: str = "tiny"):
        super().__init__()
        dims, depths = self.CONFIGS[variant]
        self.dims = dims
        self.stem = nn.Sequential(
            ConvBN(3, dims[0] // 2, 3, stride=2, act=True),
            ConvBN(dims[0] // 2, dims[0], 3, stride=2),
        )
        self.embeds = nn.ModuleList()
        self.stages = nn.ModuleList()
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            self.embeds.append(nn.Identity() if i == 0 else ConvBN(dims[i - 1], dim, 3, stride=2))
            self.stages.append(nn.ModuleList([MSCANBlock(dim) for _ in range(depth)]))

    def forward(self, x):
        feats = []
        x = self.stem(x)
        for i, blocks in enumerate(self.stages):
            if not isinstance(self.embeds[i], nn.Identity):
                x = self.embeds[i](x)
            for blk in blocks:
                x = blk(x)
            feats.append(x)
        return feats

    def export_onnx(self, b: GraphBuilder, x: str) -> list[str]:
        feats = []
        x = _export_module(b, self.stem, x)
        for i, blocks in enumerate(self.stages):
            if not isinstance(self.embeds[i], nn.Identity):
                x = self.embeds[i].export_onnx(b, x)
            for blk in blocks:
                x = blk.export_onnx(b, x)
            feats.append(x)
        return feats


class FPNDecoder(nn.Module):
    """1x1 laterals to a shared width, top-down bilinear upsample + add,
    3x3 smoothing; output at the stride-4 level."""

    def __init__(self, dims, width=64):
        super().__init__()
        self.laterals = nn.ModuleList([nn.Conv2d(d, width, 1) for d in dims])
        self.smooth = nn.ModuleList([ConvBN(width, width, 3, act=True) for _ in dims[:-1]])
        self.up = nn.Upsample(scale_factor=2, mode="bilinear")

    def forward(self, feats):
        x = self.laterals[-1](feats[-1])
        for i in range(len(feats) - 2, -1, -1):
            x = self.smooth[i](self.laterals[i](feats[i]) + self.up(x))
        return x

    def export_onnx(self, b: GraphBuilder, feats: list[str]) -> str:
        x = _export_module(b, self.laterals[-1], feats[-1])
        for i in range(len(feats) - 2, -1, -1):
            lat = _export_module(b, self.laterals[i], feats[i])
            x = b.node("Add", [lat, _export_module(b, self.up, x)])[0]
            x = self.smooth[i].export_onnx(b, x)
        return x


class FieldHead(nn.Module):
    """3x3 conv -> GELU -> 3x3 conv to (field + confidence) channels."""

    def __init__(self, width, n_field):
        super().__init__()
        self.conv1 = ConvBN(width, width, 3, act=True)
        self.conv2 = nn.Conv2d(width, n_field + 1, 3, padding=1)
        self.n_field = n_field

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out[:, : self.n_field], out[:, self.n_field :]

    def export_onnx(self, b: GraphBuilder, x: str):
        out = _export_module(b, self.conv2, self.conv1.export_onnx(b, x))
        return b.node("Split", [out], n_out=2, axis=1, split=[self.n_field, 1])


class GeoCalibFields(nn.Module):
    """Full perspective-field network: MSCAN -> FPN -> up/latitude heads,
    fields upsampled to the input resolution. Output order matches the
    reference executor contract (vertical.py::FIELD_NAMES):
    (up_field (B,2,H,W) unit-normalized, up_confidence (B,1,H,W) sigmoid,
    latitude_field (B,1,H,W) tanh * pi/2, latitude_confidence sigmoid)."""

    def __init__(self, variant: str = "tiny", decoder_width: int = 64):
        super().__init__()
        self.encoder = MSCAN(variant)
        self.decoder = FPNDecoder(self.encoder.dims, decoder_width)
        self.up_head = FieldHead(decoder_width, 2)
        self.lat_head = FieldHead(decoder_width, 1)
        self.out_up = nn.Upsample(scale_factor=4, mode="bilinear")

    def forward(self, x):
        feats = self.encoder(x)
        d = self.decoder(feats)
        up_raw, up_conf = self.up_head(d)
        lat_raw, lat_conf = self.lat_head(d)
        up = self.out_up(up_raw)
        norm = torch.sqrt(torch.sum(up * up, dim=1, keepdim=True) + 1e-8)
        up = up / norm
        up_conf = torch.sigmoid(self.out_up(up_conf))
        lat = torch.tanh(self.out_up(lat_raw)) * (np.pi / 2)
        lat_conf = torch.sigmoid(self.out_up(lat_conf))
        return up, up_conf, lat, lat_conf

    def export_onnx_model(self, input_hw=(320, 320)):
        b = GraphBuilder("input", (1, 3, *input_hw))
        feats = self.encoder.export_onnx(b, "input")
        d = self.decoder.export_onnx(b, feats)
        up_raw, up_conf = self.up_head.export_onnx(b, d)
        lat_raw, lat_conf = self.lat_head.export_onnx(b, d)
        up = _export_module(b, self.out_up, up_raw)
        # unit normalization via 2 * channel-mean of squares (2 channels)
        sq = b.node("Mul", [up, up])[0]
        ms = b.node("ReduceMean", [sq], axes=[1], keepdims=1)[0]
        two = b.init(np.float32(2.0), "nrm2")
        eps = b.init(np.float32(1e-8), "nrmeps")
        norm = b.node("Sqrt", [b.node("Add", [b.node("Mul", [ms, two])[0], eps])[0]])[0]
        up = b.node("Div", [up, norm])[0]
        up_conf = b.node("Sigmoid", [_export_module(b, self.out_up, up_conf)])[0]
        half_pi = b.init(np.float32(np.pi / 2), "halfpi")
        lat = b.node("Mul", [b.node("Tanh", [_export_module(b, self.out_up, lat_raw)])[0], half_pi])[0]
        lat_conf = b.node("Sigmoid", [_export_module(b, self.out_up, lat_conf)])[0]
        # stable output names in the reference contract's order
        names = ["up_field", "up_confidence", "latitude_field", "latitude_confidence"]
        outs = []
        for name, t in zip(names, (up, up_conf, lat, lat_conf)):
            b.node("Identity", [t])
            b.graph.nodes[-1].outputs = [name]
            outs.append(name)
        return b.finish(outs)

    def seed_constant_up(self, direction=(0.0, -1.0)):
        """Zero the up head's final conv and set its bias so the network
        emits a CONSTANT unit up field (useful for end-to-end tests: the
        whole real graph executes, and the gravity fit has a known
        answer)."""
        with torch.no_grad():
            self.up_head.conv2.weight.zero_()
            self.up_head.conv2.bias.zero_()
            self.up_head.conv2.bias[0] = direction[0]
            self.up_head.conv2.bias[1] = direction[1]
            self.up_head.conv2.bias[2] = 3.0  # confident
