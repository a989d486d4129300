"""First-party ONNX file format: protobuf wire-format reader and writer.

Host-only copy of caliscope_tpu/pose/onnx_proto.py. Neither the `onnx`
package nor onnxruntime is needed (or present on the GPU machine): ONNX is
plain protobuf, and the wire format is simple — varint keys (field_number
<< 3 | wire_type), varint/64-bit/length-delimited/32-bit payloads. This
module decodes exactly the ModelProto subset inference needs (graph
topology, node attributes, initializer tensors) and encodes the same subset,
byte for byte as the JAX package's writer does. Field numbers follow the
public onnx.proto3 schema.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# TensorProto.DataType (onnx.proto3)
DT_FLOAT = 1
DT_UINT8 = 2
DT_INT8 = 3
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_FLOAT16 = 10
DT_DOUBLE = 11

_NP_OF_DT = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
}
_DT_OF_NP = {np.dtype(v): k for k, v in _NP_OF_DT.items()}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class OnnxGraph:
    name: str = ""
    nodes: list[OnnxNode] = field(default_factory=list)
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: list[str] = field(default_factory=list)  # graph inputs EXCLUDING initializers
    outputs: list[str] = field(default_factory=list)
    input_shapes: dict[str, tuple] = field(default_factory=dict)  # may contain None dims


@dataclass
class OnnxModel:
    graph: OnnxGraph
    opset: int = 17
    producer: str = "caliscope_tpu"


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} for field {fnum}")
        yield fnum, wtype, val


def _packed_or_repeated_varints(existing: list, wtype: int, val) -> None:
    if wtype == 2:  # packed
        pos = 0
        while pos < len(val):
            v, pos = _read_varint(val, pos)
            existing.append(v)
    else:
        existing.append(val)


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = DT_FLOAT
    name = ""
    raw = b""
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            _packed_or_repeated_varints(dims, wtype, val)
        elif fnum == 2:
            dtype = val
        elif fnum == 4:
            if wtype == 2:
                float_data.extend(np.frombuffer(val, "<f4").tolist())
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 5:
            _packed_or_repeated_varints(int32_data, wtype, val)
        elif fnum == 7:
            _packed_or_repeated_varints(int64_data, wtype, val)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:
            if wtype == 2:
                double_data.extend(np.frombuffer(val, "<f8").tolist())
            else:
                double_data.append(struct.unpack("<d", val)[0])
    np_dtype = _NP_OF_DT.get(dtype)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor dtype {dtype} for initializer {name!r}")
    if raw:
        arr = np.frombuffer(raw, np_dtype).reshape(dims).copy()
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(dims)
    elif int64_data:
        arr = np.asarray([_to_signed64(v) for v in int64_data], np.int64).reshape(dims)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32).astype(np_dtype).reshape(dims)
    elif double_data:
        arr = np.asarray(double_data, np.float64).reshape(dims)
    else:
        arr = np.zeros(dims, np_dtype)
    return name, arr.astype(np_dtype, copy=False)


def _parse_attribute(buf: bytes) -> tuple[str, object]:
    name = ""
    atype = None
    f_val = None
    i_val = None
    s_val = None
    t_val = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = _to_signed64(val)
        elif fnum == 4:
            s_val = val
        elif fnum == 5:
            t_val = _parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == 2 and len(val) % 4 == 0 and len(val) > 4:
                floats.extend(np.frombuffer(val, "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            raw_ints: list[int] = []
            _packed_or_repeated_varints(raw_ints, wtype, val)
            ints.extend(_to_signed64(v) for v in raw_ints)
        elif fnum == 9:
            strings.append(val)
        elif fnum == 20:
            atype = val
    if atype == ATTR_FLOAT or (atype is None and f_val is not None):
        return name, f_val
    if atype == ATTR_INT or (atype is None and i_val is not None):
        return name, i_val
    if atype == ATTR_STRING or (atype is None and s_val is not None):
        return name, s_val.decode()
    if atype == ATTR_TENSOR or (atype is None and t_val is not None):
        return name, t_val
    if atype == ATTR_FLOATS:
        return name, list(floats)
    if atype == ATTR_INTS:
        return name, list(ints)
    if atype == ATTR_STRINGS:
        return name, [s.decode() for s in strings]
    # fall back on whichever repeated field is populated
    return name, list(ints) if ints else list(floats) if floats else None


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="")
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: bytes) -> tuple[str, tuple]:
    name = ""
    shape: tuple = ()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 2:  # shape
                            dims = []
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dim_val = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = v5
                                    dims.append(dim_val)
                            shape = tuple(dims)
    return name, shape


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    declared_inputs: list[tuple[str, tuple]] = []
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            declared_inputs.append(_parse_value_info(val))
        elif fnum == 12:
            name, _shape = _parse_value_info(val)
            g.outputs.append(name)
    for name, shape in declared_inputs:
        if name not in g.initializers:
            g.inputs.append(name)
            g.input_shapes[name] = shape
    return g


def parse_model(data: bytes) -> OnnxModel:
    graph = None
    opset = 17
    producer = ""
    for fnum, wtype, val in _iter_fields(data):
        if fnum == 7:
            graph = _parse_graph(val)
        elif fnum == 2:
            producer = val.decode()
        elif fnum == 8:  # opset_import: OperatorSetIdProto {domain=1, version=2}
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 2:
                    opset = v2
    if graph is None:
        raise ValueError("no graph in ONNX model")
    return OnnxModel(graph=graph, opset=opset, producer=producer)


def load_model(path) -> OnnxModel:
    with open(path, "rb") as f:
        return parse_model(f.read())


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | wtype) + payload


def _ld(fnum: int, payload: bytes) -> bytes:
    return _field(fnum, 2, _varint(len(payload)) + payload)


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = _DT_OF_NP.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype} for tensor {name!r}")
    out = b"".join(_field(1, 0, _varint(int(d))) for d in arr.shape)
    out += _field(2, 0, _varint(dt))
    out += _ld(8, name.encode())
    out += _ld(9, np.ascontiguousarray(arr).tobytes())
    return out


def _enc_attr(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, bool):
        out += _field(3, 0, _varint(int(value))) + _field(20, 0, _varint(ATTR_INT))
    elif isinstance(value, int):
        out += _field(3, 0, _varint(value)) + _field(20, 0, _varint(ATTR_INT))
    elif isinstance(value, float):
        out += _field(2, 5, struct.pack("<f", value)) + _field(20, 0, _varint(ATTR_FLOAT))
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _field(20, 0, _varint(ATTR_STRING))
    elif isinstance(value, np.ndarray):
        out += _ld(5, _enc_tensor("", value)) + _field(20, 0, _varint(ATTR_TENSOR))
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += b"".join(_field(8, 0, _varint(int(v))) for v in value)
            out += _field(20, 0, _varint(ATTR_INTS))
        elif all(isinstance(v, (float, np.floating)) for v in value):
            out += b"".join(_field(7, 5, struct.pack("<f", float(v))) for v in value)
            out += _field(20, 0, _varint(ATTR_FLOATS))
        elif all(isinstance(v, str) for v in value):
            out += b"".join(_ld(9, v.encode()) for v in value)
            out += _field(20, 0, _varint(ATTR_STRINGS))
        else:
            raise ValueError(f"mixed attribute list for {name!r}")
    else:
        raise ValueError(f"unsupported attribute {name!r} = {value!r}")
    return out


def _enc_node(node: OnnxNode) -> bytes:
    out = b"".join(_ld(1, s.encode()) for s in node.inputs)
    out += b"".join(_ld(2, s.encode()) for s in node.outputs)
    if node.name:
        out += _ld(3, node.name.encode())
    out += _ld(4, node.op_type.encode())
    out += b"".join(_ld(5, _enc_attr(k, v)) for k, v in node.attrs.items())
    return out


def _enc_value_info(name: str, shape: tuple | None, elem_type: int = DT_FLOAT) -> bytes:
    dims = b""
    for d in shape or ():
        dim_body = _field(1, 0, _varint(int(d))) if d is not None else _ld(2, b"N")
        dims += _ld(1, dim_body)
    tensor_type = _field(1, 0, _varint(elem_type)) + _ld(2, dims)
    type_proto = _ld(1, tensor_type)
    return _ld(1, name.encode()) + _ld(2, type_proto)


def write_model(model: OnnxModel) -> bytes:
    g = model.graph
    body = b"".join(_ld(1, _enc_node(n)) for n in g.nodes)
    if g.name:
        body += _ld(2, g.name.encode())
    body += b"".join(_ld(5, _enc_tensor(k, v)) for k, v in g.initializers.items())
    for name in g.inputs:
        body += _ld(11, _enc_value_info(name, g.input_shapes.get(name)))
    for name in g.outputs:
        body += _ld(12, _enc_value_info(name, None))
    out = _field(1, 0, _varint(8))  # ir_version
    out += _ld(2, model.producer.encode())
    out += _ld(7, body)
    opset_body = _ld(1, b"") + _field(2, 0, _varint(model.opset))
    out += _ld(8, opset_body)
    return out


def save_model(model: OnnxModel, path) -> None:
    with open(path, "wb") as f:
        f.write(write_model(model))
