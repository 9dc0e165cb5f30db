"""Minimal ONNX reader (port of ``utils/onnx_lite.py``, numpy only): a
protobuf wire-format parser and the ONNX messages the executor needs.

The reference application ships its face models as ONNX binaries
(``MediaPipeFaceDetector.onnx``, ``MediaPipeFaceLandmarkDetector.onnx``,
``blaze.onnx``; the first two are committed under ``weights/face_ref/``).
No ``onnx`` package is needed: the schema's field numbers are stable and
public, so :func:`load` parses the file into a :class:`Model` (nodes,
attributes, initializers as numpy arrays, graph inputs and outputs), and
utils/onnx_exec.py::build_torch_fn runs it with torch ops.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _s64(v: int) -> int:
    """Interpret a varint as a signed int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# ONNX message readers (field numbers per onnx/onnx.proto)
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = None
    raw = None
    name = ""
    f32: list[bytes] = []
    i32: list[int] = []
    i64: list[int] = []
    dbl: list[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:  # dims
            if wtype == 0:
                dims.append(_s64(val))
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(_s64(v))
        elif fnum == 2:
            dtype = _DTYPES[val]
        elif fnum == 4:  # float_data
            if wtype == 2:
                f32.append(val)
            else:
                f32.append(val)  # single 32-bit
        elif fnum == 5:  # int32_data (also u8/i8/f16 storage)
            if wtype == 0:
                i32.append(_s64(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    i32.append(_s64(v))
        elif fnum == 7:  # int64_data
            if wtype == 0:
                i64.append(_s64(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    i64.append(_s64(v))
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:  # double_data
            dbl.append(val)
    if dtype is None:
        raise ValueError(f"tensor {name!r}: missing data_type")
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    elif f32:
        arr = np.frombuffer(b"".join(f32), dtype=np.float32).reshape(shape)
        arr = arr.astype(dtype)
    elif i64:
        arr = np.asarray(i64, dtype=np.int64).reshape(shape)
    elif i32:
        # int32_data stores int32/int16/int8/uint8/bool/float16 payloads
        arr = np.asarray(i32, dtype=np.int64)
        if dtype == np.float16:
            arr = arr.astype(np.uint16).view(np.float16)
        else:
            arr = arr.astype(dtype)
        arr = arr.reshape(shape)
    elif dbl:
        arr = np.frombuffer(b"".join(dbl), dtype=np.float64).reshape(shape)
        arr = arr.astype(dtype)
    else:
        arr = np.zeros(shape, dtype=dtype)
    return name, arr


@dataclass
class Attr:
    name: str
    f: float | None = None
    i: int | None = None
    s: bytes | None = None
    t: np.ndarray | None = None
    floats: list[float] = field(default_factory=list)
    ints: list[int] = field(default_factory=list)

    @property
    def value(self):
        for v in (self.i, self.f, self.s, self.t):
            if v is not None:
                return v
        if self.ints:
            return self.ints
        if self.floats:
            return self.floats
        return None


def _parse_attr(buf: bytes) -> Attr:
    a = Attr(name="")
    atype = None
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            a.name = val.decode()
        elif fnum == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a.i = _s64(val)
        elif fnum == 4:
            a.s = val
        elif fnum == 5:
            a.t = _parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == 5:
                a.floats.append(struct.unpack("<f", val)[0])
            else:
                a.floats.extend(
                    struct.unpack(f"<{len(val) // 4}f", val)
                )
        elif fnum == 8:
            if wtype == 0:
                a.ints.append(_s64(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    a.ints.append(_s64(v))
        elif fnum == 20:
            atype = val
    # AttributeProto.type disambiguates INT(2) set-but-zero etc.; with the
    # defaults above a zero INT arrives as i=0 already, so atype is unused
    del atype
    return a


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Attr]
    name: str = ""

    def attr(self, key: str, default=None):
        a = self.attrs.get(key)
        return default if a is None else a.value


def _parse_node(buf: bytes) -> Node:
    inputs, outputs, attrs = [], [], {}
    op_type = ""
    name = ""
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(val.decode())
        elif fnum == 2:
            outputs.append(val.decode())
        elif fnum == 3:
            name = val.decode()
        elif fnum == 4:
            op_type = val.decode()
        elif fnum == 5:
            a = _parse_attr(val)
            attrs[a.name] = a
    return Node(op_type, inputs, outputs, attrs, name)


def _parse_value_info(buf: bytes) -> tuple[str, tuple]:
    """Returns (name, shape) -- dims 0 where symbolic."""
    name = ""
    shape: tuple = ()
    for fnum, _w, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 2:  # TensorShapeProto
                            dims = []
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dv = 0
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = _s64(v5)
                                    dims.append(dv)
                            shape = tuple(dims)
    return name, shape


@dataclass
class Graph:
    nodes: list[Node]
    initializers: dict[str, np.ndarray]
    inputs: list[tuple[str, tuple]]   # (name, shape) excluding initializers
    outputs: list[str]
    name: str = ""


def _parse_graph(buf: bytes) -> Graph:
    nodes, inits, inputs, outputs = [], {}, [], []
    name = ""
    for fnum, _w, val in _iter_fields(buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 2:
            name = val.decode()
        elif fnum == 5:
            nm, arr = _parse_tensor(val)
            inits[nm] = arr
        elif fnum == 11:
            inputs.append(_parse_value_info(val))
        elif fnum == 12:
            outputs.append(_parse_value_info(val)[0])
    inputs = [(n, s) for (n, s) in inputs if n not in inits]
    return Graph(nodes, inits, inputs, outputs, name)


@dataclass
class Model:
    graph: Graph
    opset: int = 0
    producer: str = ""


def load(path: str) -> Model:
    """Parse an .onnx file into a Model (no onnx package required)."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    opset = 0
    producer = ""
    for fnum, _w, val in _iter_fields(buf):
        if fnum == 7:
            graph = _parse_graph(val)
        elif fnum == 2:
            producer = val.decode()
        elif fnum == 8:  # opset_import
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 2:
                    opset = max(opset, _s64(v2))
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX model?)")
    return Model(graph, opset, producer)


def op_inventory(model: Model) -> dict[str, int]:
    inv: dict[str, int] = {}
    for n in model.graph.nodes:
        inv[n.op_type] = inv.get(n.op_type, 0) + 1
    return dict(sorted(inv.items(), key=lambda kv: -kv[1]))
