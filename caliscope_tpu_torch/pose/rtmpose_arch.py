"""Architecture-faithful RTMPose network family in torch, with first-party
ONNX export.

The port's own copy of caliscope_tpu/pose/rtmpose_arch.py (the RTMPose
family of the shipped model cards: backbone/head per the public RTMPose
report, arXiv:2303.07399), built layer for layer:

- CSPNeXt backbone: 3-conv stem, four stages of [stride-2 ConvModule +
  CSPLayer], CSPNeXt blocks (3x3 ConvModule + 5x5 depthwise-separable),
  channel attention (GAP -> 1x1 conv -> hardsigmoid gate), and an SPP
  bottleneck (5/9/13 max-pool pyramid) in the last stage. SiLU + BN
  throughout. Tiny/small/medium variants via (deepen, widen) factors.
- RTMCC head: 7x7 conv to per-keypoint token maps, flatten to tokens,
  ScaleNorm + token Linear into the embedding, one GAU block (relu^2
  gated attention with per-head query/key scale-offsets), and the two
  SimCC classification branches (x bins = W * 2, y bins = H * 2).

Weights are random until a checkpoint is in the repository (none can be
downloaded here); what this module pins down is the exact op graph. Every
composite block implements `export_onnx(builder, x)` (torch_onnx.py's
protocol hook), so the model exports through the first-party writer and
runs through pose/onnx_torch.py's OnnxTorchSession. Export reads the
weights from wherever the module lives.
"""

from __future__ import annotations

import math

import numpy as np

import torch
import torch.nn as nn

from caliscope_tpu_torch.pose.torch_onnx import GraphBuilder, _export_module


def conv_module(c_in: int, c_out: int, k: int, stride: int = 1, groups: int = 1):
    """ConvModule = Conv + BN + SiLU (CSPNeXt's universal building brick)."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, groups=groups, bias=False),
        nn.BatchNorm2d(c_out),
        nn.SiLU(),
    )


def dw_separable(c_in: int, c_out: int, k: int = 5):
    """Depthwise 5x5 + pointwise 1x1, each Conv+BN+SiLU."""
    return nn.Sequential(
        conv_module(c_in, c_in, k, groups=c_in),
        conv_module(c_in, c_out, 1),
    )


class CSPNeXtBlock(nn.Module):
    """3x3 ConvModule -> 5x5 depthwise-separable, with identity add."""

    def __init__(self, c_in: int, c_out: int, expansion: float = 0.5):
        super().__init__()
        hidden = int(c_out * expansion)
        self.conv1 = conv_module(c_in, hidden, 3)
        self.conv2 = dw_separable(hidden, c_out, 5)
        self.add_identity = c_in == c_out

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        out = _export_module(b, self.conv1, x)
        out = _export_module(b, self.conv2, out)
        if self.add_identity:
            out = b.node("Add", [out, x])[0]
        return out


class ChannelAttention(nn.Module):
    """GAP -> 1x1 conv -> hardsigmoid -> channel gate (CSPNeXt's CA)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)
        self.act = nn.Hardsigmoid()

    def forward(self, x):
        gate = self.act(self.fc(x.mean(dim=(2, 3), keepdim=True)))
        return x * gate

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        g = b.node("GlobalAveragePool", [x])[0]
        w = b.init(self.fc.weight.detach().cpu().numpy(), "ca_w")
        bias = b.init(self.fc.bias.detach().cpu().numpy(), "ca_b")
        g = b.node("Conv", [g, w, bias], kernel_shape=[1, 1], strides=[1, 1], pads=[0, 0, 0, 0])[0]
        g = b.node("HardSigmoid", [g], alpha=1.0 / 6.0, beta=0.5)[0]
        return b.node("Mul", [x, g])[0]


class CSPLayer(nn.Module):
    """Cross-stage partial layer: split -> blocks -> concat -> CA -> fuse."""

    def __init__(self, c_in: int, c_out: int, n_blocks: int, expand_ratio: float = 0.5):
        super().__init__()
        mid = int(c_out * expand_ratio)
        self.main_conv = conv_module(c_in, mid, 1)
        self.short_conv = conv_module(c_in, mid, 1)
        self.blocks = nn.ModuleList([CSPNeXtBlock(mid, mid) for _ in range(n_blocks)])
        self.attention = ChannelAttention(2 * mid)
        self.final_conv = conv_module(2 * mid, c_out, 1)

    def forward(self, x):
        main = self.main_conv(x)
        for blk in self.blocks:
            main = blk(main)
        both = torch.cat([main, self.short_conv(x)], dim=1)
        return self.final_conv(self.attention(both))

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        main = _export_module(b, self.main_conv, x)
        for blk in self.blocks:
            main = blk.export_onnx(b, main)
        short = _export_module(b, self.short_conv, x)
        both = b.node("Concat", [main, short], axis=1)[0]
        both = self.attention.export_onnx(b, both)
        return _export_module(b, self.final_conv, both)


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling: 1x1 -> {id, maxpool 5/9/13} concat -> 1x1."""

    def __init__(self, c_in: int, c_out: int, kernels=(5, 9, 13)):
        super().__init__()
        mid = c_in // 2
        self.conv1 = conv_module(c_in, mid, 1)
        self.pools = nn.ModuleList([nn.MaxPool2d(k, stride=1, padding=k // 2) for k in kernels])
        self.conv2 = conv_module(mid * (len(kernels) + 1), c_out, 1)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [p(x) for p in self.pools], dim=1))

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        x = _export_module(b, self.conv1, x)
        outs = [x] + [_export_module(b, p, x) for p in self.pools]
        cat = b.node("Concat", outs, axis=1)[0]
        return _export_module(b, self.conv2, cat)


class CSPNeXt(nn.Module):
    """CSPNeXt backbone, P5 arch, final-stage output only (RTMPose's input).

    Base channels (64, 128, 256, 512, 1024) and depths (3, 6, 6, 3) scaled
    by (widen, deepen): tiny = (0.375, 0.167), small = (0.5, 0.33),
    medium = (0.75, 0.67).
    """

    ARCH = [(64, 128, 3), (128, 256, 6), (256, 512, 6), (512, 1024, 3)]

    def __init__(self, deepen: float = 0.167, widen: float = 0.375):
        super().__init__()
        ch = [max(int(round(c * widen)), 1) for c in (64, 128, 256, 512, 1024)]
        self.stem = nn.Sequential(
            conv_module(3, ch[0] // 2, 3, stride=2),
            conv_module(ch[0] // 2, ch[0] // 2, 3),
            conv_module(ch[0] // 2, ch[0], 3),
        )
        stages = []
        c_prev = ch[0]
        for i, (_, base_out, base_depth) in enumerate(self.ARCH):
            c_out = ch[i + 1]
            depth = max(int(round(base_depth * deepen)), 1)
            stage = [conv_module(c_prev, c_out, 3, stride=2)]
            if i == len(self.ARCH) - 1:
                stage.append(SPPBottleneck(c_out, c_out))
            stage.append(CSPLayer(c_out, c_out, depth))
            stages.append(nn.Sequential(*stage))
            c_prev = c_out
        self.stages = nn.ModuleList(stages)
        self.out_channels = c_prev

    def forward(self, x):
        x = self.stem(x)
        for s in self.stages:
            x = s(x)
        return x

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        x = _export_module(b, self.stem, x)
        for s in self.stages:
            x = _export_module(b, s, x)
        return x


class TokenLinear(nn.Module):
    """Linear over the last dim of (B, K, D) tokens (exports as MatMul+Add —
    ONNX Gemm is 2-D only)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.lin = nn.Linear(d_in, d_out, bias=bias)

    def forward(self, x):
        return self.lin(x)

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        w = b.init(self.lin.weight.detach().cpu().numpy().T.copy(), "tok_w")
        out = b.node("MatMul", [x, w])[0]
        if self.lin.bias is not None:
            bias = b.init(self.lin.bias.detach().cpu().numpy(), "tok_b")
            out = b.node("Add", [out, bias])[0]
        return out


class ScaleNorm(nn.Module):
    """x * g / max(||x|| / sqrt(d), eps) over the last dim (RTMCC's norm)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = dim**-0.5
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = torch.norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp(min=self.eps) * self.g

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        sq = b.node("Mul", [x, x])[0]
        ms = b.node("ReduceMean", [sq], axes=[-1], keepdims=1)[0]
        norm = b.node("Sqrt", [ms])[0]  # == ||x|| / sqrt(d)
        norm = b.node("Clip", [norm, b.init(np.float32(self.eps), "sn_min"), b.init(np.float32(np.inf), "sn_max")])[0]
        out = b.node("Div", [x, norm])[0]
        return b.node("Mul", [out, b.init(self.g.detach().cpu().numpy().astype(np.float32), "sn_g")])[0]


class GAU(nn.Module):
    """Gated attention unit (RTMCC block, self-attention mode).

    uv-projection -> split (u, v, base); query/key from per-dim scale-offset
    of the shared base; relu^2 attention; gated value path; out projection;
    residual add. Matches the RTMPose head's published structure with
    use_rel_bias=False (a released configuration).
    """

    def __init__(self, dim: int, expansion: int = 2, s: int = 128):
        super().__init__()
        self.e = dim * expansion
        self.s = s
        self.norm = ScaleNorm(dim)
        self.uv = TokenLinear(dim, 2 * self.e + s)
        self.act = nn.SiLU()
        self.gamma = nn.Parameter(torch.randn(2, s) * 0.02)
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.o = TokenLinear(self.e, dim)

    def forward(self, x):
        res = x
        x = self.norm(x)
        uv = self.act(self.uv(x))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        q = base * self.gamma[0] + self.beta[0]
        k = base * self.gamma[1] + self.beta[1]
        # published RTMCC scaling: qk / sqrt(s), s = 128 (mmpose RTMCCBlock)
        qk = torch.bmm(q, k.transpose(1, 2)) / (self.s**0.5)
        attn = torch.relu(qk) ** 2
        out = u * torch.bmm(attn, v)
        return res + self.o(out)

    def export_onnx(self, b: GraphBuilder, x: str) -> str:
        res = x
        xn = self.norm.export_onnx(b, x)
        uv = self.uv.export_onnx(b, xn)
        s = b.node("Sigmoid", [uv])[0]
        uv = b.node("Mul", [uv, s])[0]  # SiLU
        u, v, base = b.node("Split", [uv], n_out=3, axis=-1, split=[self.e, self.e, self.s])
        g = self.gamma.detach().cpu().numpy().astype(np.float32)
        be = self.beta.detach().cpu().numpy().astype(np.float32)
        q = b.node("Add", [b.node("Mul", [base, b.init(g[0], "gau_gq")])[0], b.init(be[0], "gau_bq")])[0]
        k = b.node("Add", [b.node("Mul", [base, b.init(g[1], "gau_gk")])[0], b.init(be[1], "gau_bk")])[0]
        kt = b.node("Transpose", [k], perm=[0, 2, 1])[0]
        qk = b.node("MatMul", [q, kt])[0]
        sqrt_s = b.init(np.float32(self.s**0.5), "gau_sqrt_s")
        qk = b.node("Div", [qk, sqrt_s])[0]
        attn = b.node("Relu", [qk])[0]
        attn = b.node("Mul", [attn, attn])[0]
        av = b.node("MatMul", [attn, v])[0]
        out = b.node("Mul", [u, av])[0]
        out = self.o.export_onnx(b, out)
        return b.node("Add", [res, out])[0]


class RTMCCHead(nn.Module):
    """7x7 conv -> tokens -> ScaleNorm+Linear -> GAU -> SimCC x/y branches."""

    def __init__(self, c_in: int, n_keypoints: int, feat_hw: tuple[int, int],
                 input_hw: tuple[int, int], embed: int = 256, simcc_ratio: float = 2.0):
        super().__init__()
        fh, fw = feat_hw
        ih, iw = input_hw
        self.n_keypoints = n_keypoints
        self.flat = fh * fw
        self.final_layer = nn.Conv2d(c_in, n_keypoints, 7, padding=3)
        self.mlp_norm = ScaleNorm(self.flat)
        self.mlp = TokenLinear(self.flat, embed, bias=False)
        self.gau = GAU(embed)
        self.cls_x = TokenLinear(embed, int(iw * simcc_ratio), bias=False)
        self.cls_y = TokenLinear(embed, int(ih * simcc_ratio), bias=False)

    def forward(self, x):
        feats = self.final_layer(x)  # (B, K, fh, fw)
        tokens = feats.flatten(2)  # (B, K, fh*fw)
        tokens = self.mlp(self.mlp_norm(tokens))
        tokens = self.gau(tokens)
        return self.cls_x(tokens), self.cls_y(tokens)

    def export_onnx(self, b: GraphBuilder, x: str) -> tuple[str, str]:
        f = _export_module(b, self.final_layer, x)
        shape = b.init(np.asarray([0, self.n_keypoints, self.flat], np.int64), "tok_shape")
        t = b.node("Reshape", [f, shape])[0]
        t = self.mlp_norm.export_onnx(b, t)
        t = self.mlp.export_onnx(b, t)
        t = self.gau.export_onnx(b, t)
        return self.cls_x.export_onnx(b, t), self.cls_y.export_onnx(b, t)


class RTMPose(nn.Module):
    """Complete RTMPose network: CSPNeXt backbone + RTMCC SimCC head."""

    VARIANTS = {"t": (0.167, 0.375), "s": (0.33, 0.5), "m": (0.67, 0.75)}

    def __init__(self, variant: str = "t", n_keypoints: int = 17, input_hw=(256, 192)):
        super().__init__()
        deepen, widen = self.VARIANTS[variant]
        self.input_hw = tuple(input_hw)
        self.backbone = CSPNeXt(deepen, widen)
        feat_hw = (input_hw[0] // 32, input_hw[1] // 32)
        self.head = RTMCCHead(self.backbone.out_channels, n_keypoints, feat_hw, self.input_hw)

    def forward(self, x):
        return self.head(self.backbone(x))

    def export_onnx_model(self):
        """Export to an OnnxModel with the production output contract:
        outputs named simcc_x (B, K, W*2) and simcc_y (B, K, H*2)."""
        b = GraphBuilder("input", (1, 3, *self.input_hw))
        feat = self.backbone.export_onnx(b, "input")
        x_out, y_out = self.head.export_onnx(b, feat)
        for src, name in ((x_out, "simcc_x"), (y_out, "simcc_y")):
            b.node("Identity", [src])
            b.graph.nodes[-1].outputs = [name]
        return b.finish(["simcc_x", "simcc_y"])
