"""Minimal ONNX protobuf wire-format writer and reader (the port's own
copy of ``paddle_tpu/onnx/_proto.py``; pure Python and numpy).

The exporter serializes ModelProto directly in the protobuf wire format
(varint + length-delimited fields — the format is stable and public), so
it needs no onnx package. Only the message fields the exporter emits are
implemented. The reader lets tests and ``chip_smoke.py`` round-trip a
model without the onnx package; any ONNX runtime can consume the files.

Field numbers follow onnx/onnx.proto (public schema):
  ModelProto:   ir_version=1 producer_name=2 graph=7 opset_import=8
  GraphProto:   node=1 name=2 initializer=5 input=11 output=12
  NodeProto:    input=1 output=2 name=3 op_type=4 attribute=5
  AttributeProto: name=1 f=2 i=3 s=4 ints=8 type=20
  TensorProto:  dims=1 data_type=2 name=8 raw_data=9
  ValueInfoProto: name=1 type=2; TypeProto.tensor_type=1
  TypeProto.Tensor: elem_type=1 shape=2; TensorShapeProto.dim=1
  Dimension:    dim_value=1
"""
from __future__ import annotations

import struct

import numpy as np

# ONNX TensorProto.DataType
FLOAT, INT32, INT64 = 1, 6, 7
_NP2ONNX = {np.dtype(np.float32): FLOAT, np.dtype(np.int32): INT32,
            np.dtype(np.int64): INT64}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_INTS = 7


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's-complement, proto int64 convention
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def field_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def field_string(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode())


def field_packed_ints(field: int, values) -> bytes:
    body = b"".join(_varint(int(v)) for v in values)
    return field_bytes(field, body)


def field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = _NP2ONNX[arr.dtype]
    msg = b"".join([
        field_packed_ints(1, arr.shape),
        field_varint(2, dt),
        field_string(8, name),
        field_bytes(9, arr.tobytes()),
    ])
    return msg


def attr_int(name: str, value: int) -> bytes:
    return b"".join([field_string(1, name), field_varint(3, value),
                     field_varint(20, ATTR_INT)])


def attr_float(name: str, value: float) -> bytes:
    return b"".join([field_string(1, name), field_float(2, value),
                     field_varint(20, ATTR_FLOAT)])


def attr_ints(name: str, values) -> bytes:
    return b"".join([field_string(1, name), field_packed_ints(8, values),
                     field_varint(20, ATTR_INTS)])


def node_proto(op_type: str, inputs, outputs, name: str = "",
               attrs: bytes = b"") -> bytes:
    msg = b"".join(field_string(1, i) for i in inputs)
    msg += b"".join(field_string(2, o) for o in outputs)
    if name:
        msg += field_string(3, name)
    msg += field_string(4, op_type)
    msg += attrs
    return msg


def _attr_wrap(attr_msgs) -> bytes:
    return b"".join(field_bytes(5, a) for a in attr_msgs)


def value_info(name: str, elem_type: int, shape) -> bytes:
    """``None`` dims emit a symbolic dim_param ("N") so dynamic batch
    survives export instead of being baked to a literal."""
    dims = b"".join(
        field_bytes(1, field_string(2, "N")) if d is None
        else field_bytes(1, field_varint(1, int(d))) for d in shape)
    shape_msg = dims
    tensor_t = field_varint(1, elem_type) + field_bytes(2, shape_msg)
    type_msg = field_bytes(1, tensor_t)
    return field_string(1, name) + field_bytes(2, type_msg)


def graph_proto(nodes, name, initializers, inputs, outputs) -> bytes:
    msg = b"".join(field_bytes(1, n) for n in nodes)
    msg += field_string(2, name)
    msg += b"".join(field_bytes(5, t) for t in initializers)
    msg += b"".join(field_bytes(11, vi) for vi in inputs)
    msg += b"".join(field_bytes(12, vi) for vi in outputs)
    return msg


def model_proto(graph: bytes, opset: int = 13,
                producer: str = "paddle_tpu_torch") -> bytes:
    opset_msg = field_string(1, "") + field_varint(2, opset)
    return b"".join([
        field_varint(1, 8),          # ir_version 8
        field_string(2, producer),
        field_bytes(7, graph),
        field_bytes(8, opset_msg),
    ])


# ---------------------------------------------------------------------------
# Reader (for round-trip tests; tolerant, parses only what the writer emits)
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def parse_message(buf: bytes):
    """-> dict field_number -> list of (wire_type, value)."""
    fields = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append((wire, val))
    return fields


def _one(fields, n, default=None):
    return fields[n][0][1] if n in fields else default


def parse_packed_ints(data: bytes):
    vals, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        if v >= 1 << 63:
            v -= 1 << 64
        vals.append(v)
    return vals


def parse_tensor(buf: bytes):
    f = parse_message(buf)
    dims = parse_packed_ints(_one(f, 1, b""))
    dt = _one(f, 2, FLOAT)
    name = _one(f, 8, b"").decode()
    raw = _one(f, 9, b"")
    arr = np.frombuffer(raw, dtype=_ONNX2NP[dt]).reshape(dims)
    return name, arr


def parse_model(buf: bytes):
    """-> {"graph": {"nodes": [...], "initializers": {name: arr},
    "inputs": [names], "outputs": [names]}, "opset": int}"""
    mf = parse_message(buf)
    g = parse_message(_one(mf, 7))
    nodes = []
    for _, nb in g.get(1, []):
        nf = parse_message(nb)
        attrs = {}
        for _, ab in nf.get(5, []):
            af = parse_message(ab)
            aname = _one(af, 1, b"").decode()
            atype = _one(af, 20, 0)
            if atype == ATTR_INT:
                v = _one(af, 3)
                attrs[aname] = v - (1 << 64) if v >= 1 << 63 else v
            elif atype == ATTR_FLOAT:
                attrs[aname] = _one(af, 2)
            elif atype == ATTR_INTS:
                attrs[aname] = parse_packed_ints(_one(af, 8, b""))
            else:
                attrs[aname] = _one(af, 4)
        nodes.append({
            "op_type": _one(nf, 4, b"").decode(),
            "inputs": [v.decode() for _, v in nf.get(1, [])],
            "outputs": [v.decode() for _, v in nf.get(2, [])],
            "attrs": attrs,
        })
    inits = dict(parse_tensor(tb) for _, tb in g.get(5, []))

    def _vi_names(field):
        return [parse_message(vb)[1][0][1].decode()
                for _, vb in g.get(field, [])]

    opset = 13
    if 8 in mf:
        opset = _one(parse_message(_one(mf, 8)), 2, 13)
    return {"graph": {"nodes": nodes, "initializers": inits,
                      "inputs": _vi_names(11), "outputs": _vi_names(12)},
            "opset": opset}
