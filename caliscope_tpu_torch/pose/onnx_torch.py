"""ONNX graph executor on torch — the port's inference engine.

Port of caliscope_tpu/pose/onnx_jax.py (`OnnxJaxSession`, `_Executor`).
The JAX package traces the graph into one XLA program; the port builds the
graph once per session (every node's op resolved, every initializer copied
to the device) and runs it eagerly on `device`, node by node, as a plain
interpreter of tensors. It covers the same op set (the CNN family of the
pose stack: RTMPose-class backbones + SimCC / heatmap heads) with the JAX
executor's semantics op for op, e.g. Resize as jax.image.resize (half-pixel
centres, triangle / Keys-cubic kernels, antialiasing when downscaling),
pooling with -inf / zero padding (an average's count excludes the pads;
ceil_mode is not read), and ConvTranspose ignoring `group`.

Shape-carrying subgraphs (Shape -> Gather -> Concat -> Reshape chains that
exporters emit) stay host numpy constants, as the JAX executor folds them:
every value that depends only on initializers and static shapes is computed
with numpy, so a Reshape target never needs a device-to-host read.

API mirrors onnxruntime far enough for the tracker:
OnnxTorchSession(model).run(None, {input_name: array}) -> list of numpy
arrays; `forward` returns the outputs as tensors on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.pose.onnx_proto import _NP_OF_DT, OnnxGraph, OnnxModel, load_model

_TORCH_OF_NP = {
    np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool,
    np.dtype(np.float16): torch.float16, np.dtype(np.float64): torch.float64,
}


def _is_const(x) -> bool:
    return isinstance(x, np.ndarray) or np.isscalar(x)


def _pair(v, n=2):
    v = list(v) if isinstance(v, (list, tuple)) else [v] * n
    return v


def _auto_pads(attrs, kernel, strides, in_shape):
    """Resolve pads from explicit attr or auto_pad (SAME_UPPER/LOWER)."""
    auto = attrs.get("auto_pad", "NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    rank = len(kernel)
    if auto in ("NOTSET", "", "VALID"):
        pads = attrs.get("pads", [0] * (2 * rank))
        return [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    pads = []
    for i in range(rank):
        out = -(-in_shape[i] // strides[i])  # ceil
        total = max((out - 1) * strides[i] + kernel[i] - in_shape[i], 0)
        lo = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
        pads.append((lo, total - lo))
    return pads


def _torch_pads(pads) -> list[int]:
    """[(lo, hi) per spatial axis] -> F.pad's order (last axis first)."""
    return [int(v) for lo, hi in reversed(pads) for v in (lo, hi)]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(input_size: int, output_size: int, kernel) -> np.ndarray:
    """(input_size, output_size) float64 weights of jax.image.resize along
    one axis (scale_and_translate with no translation, antialiased): half-
    pixel centres, the kernel widened by 1/scale when downscaling, columns
    normalized, samples outside the input zeroed."""
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(output_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=np.float64)[:, None]) / kernel_scale
    weights = kernel(x)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    return np.where(((sample_f >= -0.5) & (sample_f <= input_size - 0.5))[None, :], weights, 0)


def resize_nearest_index(input_size: int, output_size: int) -> np.ndarray:
    """jax.image.resize's nearest source index per output (float32 math)."""
    offsets = (np.arange(output_size, dtype=np.float32) + np.float32(0.5)) * input_size / output_size
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


class _Executor:
    """One ONNX graph as a list of resolved ops over an environment of
    numpy constants and device tensors."""

    def __init__(self, graph: OnnxGraph, device: torch.device):
        self.graph = graph
        self.device = device
        missing = sorted({n.op_type for n in graph.nodes if not hasattr(self, f"op_{n.op_type}")})
        if missing:
            raise NotImplementedError(f"ONNX op {', '.join(missing)} is not implemented")
        self._ops = [(getattr(self, f"op_{n.op_type}"), n) for n in graph.nodes]
        # device copies of the initializers, keyed by the numpy array's id
        # (the graph holds the arrays, so the ids stay valid)
        self._dev = {id(a): (a, torch.as_tensor(a, device=device)) for a in graph.initializers.values()}
        self._memo: dict = {}  # per-session constants: BN scale and shift, Resize weights

    def t(self, x):
        """A device tensor of x (a tensor, an initializer or a folded
        numpy constant)."""
        if isinstance(x, torch.Tensor):
            return x
        hit = self._dev.get(id(x))
        if hit is not None and hit[0] is x:
            return hit[1]
        return torch.as_tensor(np.asarray(x), device=self.device)

    def __call__(self, feeds: dict):
        env: dict[str, object] = dict(self.graph.initializers)
        env.update(feeds)
        env[""] = None  # optional-input placeholder
        for fn, node in self._ops:
            args = [env[i] for i in node.inputs]
            out = fn(node.attrs, *args)
            if not isinstance(out, tuple):
                out = (out,)
            for name, val in zip(node.outputs, out):
                if name:
                    env[name] = val
        return [env[name] for name in self.graph.outputs]

    # ---- convolution / linear --------------------------------------------------
    def op_Conv(self, attrs, x, w, b=None):
        x, w = self.t(x), self.t(w)
        rank = w.ndim - 2
        kernel = attrs.get("kernel_shape", list(w.shape[2:]))
        strides = _pair(attrs.get("strides", [1] * rank), rank)
        dil = _pair(attrs.get("dilations", [1] * rank), rank)
        groups = int(attrs.get("group", 1))
        pads = _auto_pads(attrs, kernel, strides, x.shape[2:])
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:
            x, padding = F.pad(x, _torch_pads(pads)), 0
        return _CONV[rank](x, w, None if b is None else self.t(b), stride=strides, padding=padding,
                           dilation=dil, groups=groups)

    def op_ConvTranspose(self, attrs, x, w, b=None):
        x, w = self.t(x), self.t(w)
        rank = w.ndim - 2
        strides = _pair(attrs.get("strides", [1] * rank), rank)
        pads = attrs.get("pads", [0] * (2 * rank))
        out_pad = _pair(attrs.get("output_padding", [0] * rank), rank)
        # the full transposed convolution, then ONNX's pads cut from each
        # end (output_padding adds zeros at the end first)
        out = _CONV_T[rank](x, w, None, stride=strides)
        for i in range(rank):
            d = 2 + i
            if out_pad[i]:
                out = torch.cat([out, out.new_zeros(out.shape[:d] + (out_pad[i],) + out.shape[d + 1:])], dim=d)
            lo, hi = int(pads[i]), int(pads[i + rank])
            out = out.narrow(d, lo, out.shape[d] - lo - hi)
        if b is not None:
            out = out + self.t(b).reshape((1, -1) + (1,) * rank)
        return out

    def op_Gemm(self, attrs, a, b, c=None):
        a, b = self.t(a), self.t(b)
        alpha = attrs.get("alpha", 1.0)
        beta = attrs.get("beta", 1.0)
        if attrs.get("transA", 0):
            a = a.transpose(-1, -2)
        if attrs.get("transB", 0):
            b = b.transpose(-1, -2)
        out = alpha * (a @ b)
        if c is not None:
            out = out + beta * self.t(c)
        return out

    def op_MatMul(self, attrs, a, b):
        return torch.matmul(self.t(a), self.t(b))

    def op_BatchNormalization(self, attrs, x, scale, bias, mean, var):
        key = id(scale), id(bias), id(mean), id(var)
        hit = self._memo.get(key)
        if hit is None:
            # the JAX executor's host arithmetic, once per session
            eps = attrs.get("epsilon", 1e-5)
            inv = 1.0 / np.sqrt(np.asarray(var) + eps)
            s = np.asarray(scale) * inv
            shift = np.asarray(bias) - np.asarray(mean) * np.asarray(scale) * inv
            shape = (1, -1) + (1,) * (len(x.shape) - 2)
            hit = self._memo[key] = (self.t(s.reshape(shape)), self.t(shift.reshape(shape)))
        return self.t(x) * hit[0] + hit[1]

    def op_LayerNormalization(self, attrs, x, scale, bias=None):
        x = self.t(x)
        axis = int(attrs.get("axis", -1))
        eps = attrs.get("epsilon", 1e-5)
        mean = torch.mean(x, dim=axis, keepdim=True)
        var = torch.var(x, dim=axis, keepdim=True, correction=0)
        out = (x - mean) / torch.sqrt(var + eps) * self.t(scale)
        return out + self.t(bias) if bias is not None else out

    # ---- activations -------------------------------------------------------------
    def op_Relu(self, attrs, x):
        return torch.relu(self.t(x))

    def op_LeakyRelu(self, attrs, x):
        x = self.t(x)
        return torch.where(x >= 0, x, x * attrs.get("alpha", 0.01))

    def op_Sigmoid(self, attrs, x):
        return torch.sigmoid(self.t(x))

    def op_HardSigmoid(self, attrs, x):
        return torch.clamp(attrs.get("alpha", 0.2) * self.t(x) + attrs.get("beta", 0.5), 0, 1)

    def op_HardSwish(self, attrs, x):
        x = self.t(x)
        return x * torch.clamp(x / 6.0 + 0.5, 0, 1)

    def op_Tanh(self, attrs, x):
        return torch.tanh(self.t(x))

    def op_Erf(self, attrs, x):
        return torch.erf(self.t(x))

    def op_Exp(self, attrs, x):
        return torch.exp(self.t(x))

    def op_Softmax(self, attrs, x):
        return torch.softmax(self.t(x), dim=int(attrs.get("axis", -1)))

    def op_Clip(self, attrs, x, lo=None, hi=None):
        x = self.t(x)
        lo = attrs.get("min", lo)
        hi = attrs.get("max", hi)
        if lo is not None:
            x = torch.maximum(x, self.t(lo).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, self.t(hi).to(x.dtype))
        return x

    # ---- elementwise ---------------------------------------------------------------
    def _binary(self, a, b, fn):
        if _is_const(a) and _is_const(b):
            return fn(np.asarray(a), np.asarray(b))
        return fn(self.t(a), self.t(b))

    def op_Add(self, attrs, a, b):
        return self._binary(a, b, lambda u, v: u + v)

    def op_Sub(self, attrs, a, b):
        return self._binary(a, b, lambda u, v: u - v)

    def op_Mul(self, attrs, a, b):
        return self._binary(a, b, lambda u, v: u * v)

    def op_Div(self, attrs, a, b):
        return self._binary(a, b, lambda u, v: u / v)

    def op_Pow(self, attrs, a, b):
        return self._binary(a, b, lambda u, v: u ** v)

    def op_Sqrt(self, attrs, x):
        return np.sqrt(x) if _is_const(x) else torch.sqrt(x)

    def op_Neg(self, attrs, x):
        return -x

    def op_Identity(self, attrs, x):
        return x

    # ---- pooling ----------------------------------------------------------------------
    def op_MaxPool(self, attrs, x):
        x = self.t(x)
        kernel = attrs["kernel_shape"]
        rank = len(kernel)
        strides = _pair(attrs.get("strides", [1] * rank), rank)
        pads = _auto_pads(attrs, kernel, strides, x.shape[2:])
        x = F.pad(x, _torch_pads(pads), value=float("-inf"))
        return _MAX_POOL[rank](x, list(kernel), list(strides))

    def op_AveragePool(self, attrs, x):
        x = self.t(x)
        kernel = attrs["kernel_shape"]
        rank = len(kernel)
        strides = _pair(attrs.get("strides", [1] * rank), rank)
        pads = _torch_pads(_auto_pads(attrs, kernel, strides, x.shape[2:]))
        area = int(np.prod(kernel))
        sums = _AVG_POOL[rank](F.pad(x, pads), list(kernel), list(strides)) * area
        ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
        counts = _AVG_POOL[rank](F.pad(ones, pads), list(kernel), list(strides)) * area
        return sums / counts

    def op_GlobalAveragePool(self, attrs, x):
        x = self.t(x)
        return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)

    @staticmethod
    def _axes(attrs, axes):
        axes = attrs.get("axes", axes)
        return tuple(int(a) for a in np.ravel(axes)) if axes is not None else None

    def op_ReduceMean(self, attrs, x, axes=None):
        x = self.t(x)
        axes = self._axes(attrs, axes)
        return torch.mean(x, dim=axes if axes is not None else tuple(range(x.ndim)),
                          keepdim=bool(attrs.get("keepdims", 1)))

    def op_ReduceMax(self, attrs, x, axes=None):
        x = self.t(x)
        axes = self._axes(attrs, axes)
        return torch.amax(x, dim=axes if axes is not None else tuple(range(x.ndim)),
                          keepdim=bool(attrs.get("keepdims", 1)))

    # ---- shape plumbing (constant-folded where possible) ---------------------------------
    def op_Shape(self, attrs, x):
        return np.asarray(tuple(x.shape), np.int64)

    def op_Cast(self, attrs, x):
        np_dtype = np.dtype(_NP_OF_DT[int(attrs["to"])])
        return np.asarray(x).astype(np_dtype) if _is_const(x) else x.to(_TORCH_OF_NP[np_dtype])

    def op_Constant(self, attrs):
        if "value" in attrs:
            return np.asarray(attrs["value"])
        for k in ("value_float", "value_int"):
            if k in attrs:
                return np.asarray(attrs[k])
        if "value_floats" in attrs:
            return np.asarray(attrs["value_floats"], np.float32)
        if "value_ints" in attrs:
            return np.asarray(attrs["value_ints"], np.int64)
        raise ValueError("Constant node without value")

    def op_ConstantOfShape(self, attrs, shape):
        value = attrs.get("value", np.zeros(1, np.float32))
        return np.full(tuple(int(s) for s in np.ravel(shape)), np.ravel(value)[0], np.asarray(value).dtype)

    def op_Reshape(self, attrs, x, shape):
        target = [int(s) for s in np.ravel(np.asarray(shape))]
        cur = list(x.shape)
        target = [cur[i] if s == 0 else s for i, s in enumerate(target)]
        return np.reshape(x, target) if _is_const(x) else torch.reshape(x, target)

    def op_Flatten(self, attrs, x):
        axis = int(attrs.get("axis", 1))
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return torch.reshape(self.t(x), (lead, -1))

    def op_Transpose(self, attrs, x):
        perm = [int(p) for p in attrs.get("perm", list(range(len(x.shape)))[::-1])]
        return np.transpose(x, perm) if _is_const(x) else x.permute(perm)

    def op_Concat(self, attrs, *xs):
        axis = int(attrs.get("axis", 0))
        if all(_is_const(x) for x in xs):
            return np.concatenate([np.atleast_1d(np.asarray(x)) for x in xs], axis=axis)
        return torch.cat([self.t(x) for x in xs], dim=axis)

    def op_Split(self, attrs, x, split=None):
        x = self.t(x)
        axis = int(attrs.get("axis", 0))
        split = attrs.get("split", split)
        n_out = attrs.get("num_outputs")
        if split is None:
            n = int(n_out) if n_out else 2
            sizes = [x.shape[axis] // n] * n
        else:
            sizes = [int(s) for s in np.ravel(split)]
        return tuple(torch.split(x, sizes, dim=axis))

    def op_Slice(self, attrs, x, starts=None, ends=None, axes=None, steps=None):
        starts = attrs.get("starts", starts)
        ends = attrs.get("ends", ends)
        axes = attrs.get("axes", axes)
        starts = [int(v) for v in np.ravel(starts)]
        ends = [int(v) for v in np.ravel(ends)]
        axes = [int(v) for v in np.ravel(axes)] if axes is not None else list(range(len(starts)))
        steps = [int(v) for v in np.ravel(steps)] if steps is not None else [1] * len(starts)
        if _is_const(x):
            slicer = [slice(None)] * np.ndim(x)
            for s, e, a, st in zip(starts, ends, axes, steps):
                slicer[a] = slice(s, None if e >= 2**31 else e, st)
            return np.asarray(x)[tuple(slicer)]
        for s, e, a, st in zip(starts, ends, axes, steps):
            idx = range(x.shape[a])[slice(s, None if e >= 2**31 else e, st)]
            if st == 1:
                x = x.narrow(a, idx.start, len(idx)) if len(idx) else x.narrow(a, 0, 0)
            else:
                x = x.index_select(a, torch.as_tensor(list(idx), dtype=torch.int64, device=x.device))
        return x

    def op_Gather(self, attrs, x, idx):
        axis = int(attrs.get("axis", 0))
        if _is_const(x) and _is_const(idx):
            return np.take(np.asarray(x), np.asarray(idx).astype(np.int64), axis=axis)
        x = self.t(x)
        axis = axis % x.ndim
        i = self.t(idx).to(torch.int64)
        i = torch.where(i < 0, i + x.shape[axis], i)
        out = x.index_select(axis, i.reshape(-1))
        return out.reshape(tuple(x.shape[:axis]) + tuple(i.shape) + tuple(x.shape[axis + 1:]))

    def op_Squeeze(self, attrs, x, axes=None):
        axes = self._axes(attrs, axes)
        if axes is None:
            return np.squeeze(x) if _is_const(x) else torch.squeeze(x)
        return np.squeeze(np.asarray(x), axis=axes) if _is_const(x) else torch.squeeze(x, dim=axes)

    def op_Unsqueeze(self, attrs, x, axes=None):
        axes = attrs.get("axes", axes)
        for a in sorted(int(a) for a in np.ravel(axes)):
            x = np.expand_dims(x, a) if _is_const(x) else torch.unsqueeze(x, a)
        return x

    def op_Expand(self, attrs, x, shape):
        x = self.t(x)
        target = tuple(int(s) for s in np.ravel(shape))
        target = tuple(max(t, s) for t, s in zip(target, (1,) * (len(target) - x.ndim) + tuple(x.shape)))
        return torch.broadcast_to(x, target)

    def op_Pad(self, attrs, x, pads=None, value=None):
        x = self.t(x)
        pads = attrs.get("pads", pads)
        pads = [int(p) for p in np.ravel(pads)]
        rank = x.ndim
        cval = float(np.ravel(value)[0]) if value is not None else 0.0
        return F.pad(x, _torch_pads([(pads[i], pads[i + rank]) for i in range(rank)]), value=cval)

    def op_Resize(self, attrs, x, roi=None, scales=None, sizes=None):
        x = self.t(x)
        mode = attrs.get("mode", "nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if sizes is not None and np.size(sizes):
            out_hw = tuple(int(s) for s in np.ravel(sizes))[2:]
        else:
            sc = np.ravel(scales)
            out_hw = tuple(int(round(x.shape[2 + i] * sc[2 + i])) for i in range(x.ndim - 2))
        if mode not in ("nearest", "linear", "cubic"):
            raise KeyError(mode)
        for i, n in enumerate(out_hw):
            d, m = 2 + i, x.shape[2 + i]
            if m == n:
                continue
            if mode == "nearest":
                idx = torch.as_tensor(resize_nearest_index(m, n), device=x.device)
                x = x.index_select(d, idx)
                continue
            key = ("resize", m, n, mode, x.dtype)
            w = self._memo.get(key)
            if w is None:
                w = self._memo[key] = torch.as_tensor(
                    resize_weights(m, n, _triangle if mode == "linear" else _keys_cubic), device=x.device
                ).to(x.dtype)
            x = torch.movedim(torch.matmul(torch.movedim(x, d, -1), w), -1, d)
        return x


class OnnxTorchSession:
    """onnxruntime-shaped facade over the executor, on `device` (CUDA
    unless the caller names another)."""

    def __init__(self, model_or_path, device=None):
        model = model_or_path if isinstance(model_or_path, OnnxModel) else load_model(model_or_path)
        self.model = model
        self.graph = model.graph
        self.device = resolve_device(device)
        self._executor = _Executor(self.graph, self.device)

    # ORT-compatible surface -------------------------------------------------------
    def get_inputs(self):
        class _IO:
            def __init__(self, name, shape):
                self.name = name
                self.shape = list(shape)

        return [_IO(n, self.graph.input_shapes.get(n) or ()) for n in self.graph.inputs]

    def get_outputs(self):
        class _IO:
            def __init__(self, name):
                self.name = name

        return [_IO(n) for n in self.graph.outputs]

    def forward(self, feeds: dict) -> list:
        """Run the graph on the device; the outputs as device tensors (or
        numpy for an output that folded to a constant)."""
        with torch.no_grad():
            return self._executor({k: torch.as_tensor(v, device=self.device) for k, v in feeds.items()})

    def run(self, output_names, feeds: dict):
        outs = [o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in self.forward(feeds)]
        if output_names:
            index = {n: i for i, n in enumerate(self.graph.outputs)}
            outs = [outs[index[n]] for n in output_names]
        return outs
