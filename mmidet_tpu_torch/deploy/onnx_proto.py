"""Self-contained ONNX protobuf codec (no ``onnx`` package dependency).

Counterpart of ``mmidet_tpu/deploy/onnx_proto.py``, copied (numpy only,
no ``onnx`` wheel).  Implements the protobuf wire format for the subset of
``onnx.proto`` needed to serialize inference graphs: ModelProto,
GraphProto, NodeProto, AttributeProto, TensorProto, ValueInfoProto,
TypeProto and OperatorSetIdProto, with both an encoder and a decoder (the
decoder exists so round-trip tests pin the encoding and so the numpy
evaluator, ``deploy/onnx_np.py``, consumes the *serialized file*, not
in-memory objects).

Field numbers follow the public ONNX schema
(github.com/onnx/onnx/blob/main/onnx/onnx.proto, stable across IR
versions 3..10).  Repeated scalar fields are written UNPACKED, which
both proto2 and proto3 parsers accept.  Opset 17 (LayerNormalization).
The wire helpers are ``pbwire``'s, which ``tf_proto`` shares.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mmidet_tpu_torch.deploy.pbwire import VARINT as _VARINT
from mmidet_tpu_torch.deploy.pbwire import Reader as _Reader
from mmidet_tpu_torch.deploy.pbwire import enc_bytes as _enc_bytes
from mmidet_tpu_torch.deploy.pbwire import enc_float as _enc_float
from mmidet_tpu_torch.deploy.pbwire import enc_int as _enc_int
from mmidet_tpu_torch.deploy.pbwire import enc_str as _enc_str

# ------------------------------------------------------------- data model

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE, BFLOAT16 = \
    1, 2, 3, 6, 7, 9, 10, 11, 16

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT, np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8, np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64, np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16, np.dtype(np.float64): DOUBLE,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS, _AT_STRINGS = 6, 7, 8


@dataclass
class Tensor:
    name: str
    array: np.ndarray

    def encode(self) -> bytes:
        a = np.ascontiguousarray(self.array)
        out = bytearray()
        for d in a.shape:
            out += _enc_int(1, d)                    # dims
        out += _enc_int(2, _NP_TO_ONNX[a.dtype])     # data_type
        if self.name:
            out += _enc_str(8, self.name)            # name
        out += _enc_bytes(9, a.tobytes())            # raw_data (little-endian)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Tensor":
        r = _Reader(buf)
        dims, dt, name, raw = [], FLOAT, "", b""
        while not r.eof():
            f, w = r.key()
            if f == 1 and w == _VARINT:
                dims.append(r.svarint())
            elif f == 2:
                dt = r.varint()
            elif f == 8:
                name = r.bytes_().decode()
            elif f == 9:
                raw = r.bytes_()
            else:
                r.skip(w)
        a = np.frombuffer(raw, _ONNX_TO_NP[dt]).reshape(dims)
        return cls(name, a)


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict = field(default_factory=dict)

    def _enc_attr(self, name: str, v) -> bytes:
        body = bytearray(_enc_str(1, name))
        if isinstance(v, float):
            body += _enc_float(2, v) + _enc_int(20, _AT_FLOAT)
        elif isinstance(v, bool) or isinstance(v, (int, np.integer)):
            body += _enc_int(3, int(v)) + _enc_int(20, _AT_INT)
        elif isinstance(v, str):
            body += _enc_bytes(4, v.encode()) + _enc_int(20, _AT_STRING)
        elif isinstance(v, np.ndarray):
            body += _enc_bytes(5, Tensor("", v).encode())
            body += _enc_int(20, _AT_TENSOR)
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
            for x in v:
                body += _enc_float(7, x)
            body += _enc_int(20, _AT_FLOATS)
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
            for x in v:
                body += _enc_bytes(9, x.encode())
            body += _enc_int(20, _AT_STRINGS)
        elif isinstance(v, (list, tuple)):
            for x in v:
                body += _enc_int(8, int(x))
            body += _enc_int(20, _AT_INTS)
        else:
            raise TypeError(f"attr {name}: {type(v)}")
        return _enc_bytes(5, bytes(body))  # NodeProto.attribute = 5

    def encode(self) -> bytes:
        out = bytearray()
        for s in self.inputs:
            out += _enc_str(1, s)
        for s in self.outputs:
            out += _enc_str(2, s)
        if self.name:
            out += _enc_str(3, self.name)
        out += _enc_str(4, self.op_type)
        for k in self.attrs:
            out += self._enc_attr(k, self.attrs[k])
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Node":
        r = _Reader(buf)
        n = cls("", [], [])
        while not r.eof():
            f, w = r.key()
            if f == 1:
                n.inputs.append(r.bytes_().decode())
            elif f == 2:
                n.outputs.append(r.bytes_().decode())
            elif f == 3:
                n.name = r.bytes_().decode()
            elif f == 4:
                n.op_type = r.bytes_().decode()
            elif f == 5:
                k, v = cls._dec_attr(r.bytes_())
                n.attrs[k] = v
            else:
                r.skip(w)
        return n

    @staticmethod
    def _dec_attr(buf: bytes):
        r = _Reader(buf)
        name, val = "", None
        floats, ints, strs = [], [], []
        while not r.eof():
            f, w = r.key()
            if f == 1:
                name = r.bytes_().decode()
            elif f == 2:
                val = r.f32()
            elif f == 3:
                val = r.svarint()
            elif f == 4:
                val = r.bytes_().decode()
            elif f == 5:
                val = Tensor.decode(r.bytes_()).array
            elif f == 7:
                floats.append(r.f32())
            elif f == 8:
                if w == _VARINT:
                    ints.append(r.svarint())
                else:  # packed
                    rr = _Reader(r.bytes_())
                    while not rr.eof():
                        ints.append(rr.svarint())
            elif f == 9:
                strs.append(r.bytes_().decode())
            else:
                r.skip(w)
        if floats:
            val = floats
        elif ints:
            val = ints
        elif strs:
            val = strs
        return name, val


@dataclass
class ValueInfo:
    name: str
    elem_type: int
    shape: tuple  # ints or strings (dim_param)

    def encode(self) -> bytes:
        dims = bytearray()
        for d in self.shape:
            if isinstance(d, str):
                dims += _enc_bytes(1, _enc_str(2, d))
            else:
                dims += _enc_bytes(1, _enc_int(1, d))
        tensor_t = _enc_int(1, self.elem_type) + _enc_bytes(2, bytes(dims))
        type_p = _enc_bytes(1, tensor_t)
        return _enc_str(1, self.name) + _enc_bytes(2, type_p)

    @classmethod
    def decode(cls, buf: bytes) -> "ValueInfo":
        r = _Reader(buf)
        name, et, shape = "", FLOAT, []
        while not r.eof():
            f, w = r.key()
            if f == 1:
                name = r.bytes_().decode()
            elif f == 2:
                rt = _Reader(r.bytes_())
                while not rt.eof():
                    ft, wt = rt.key()
                    if ft == 1:  # tensor_type
                        rtt = _Reader(rt.bytes_())
                        while not rtt.eof():
                            f2, w2 = rtt.key()
                            if f2 == 1:
                                et = rtt.varint()
                            elif f2 == 2:  # shape
                                rs = _Reader(rtt.bytes_())
                                while not rs.eof():
                                    f3, w3 = rs.key()
                                    if f3 == 1:
                                        rd = _Reader(rs.bytes_())
                                        while not rd.eof():
                                            f4, w4 = rd.key()
                                            if f4 == 1:
                                                shape.append(rd.svarint())
                                            elif f4 == 2:
                                                shape.append(
                                                    rd.bytes_().decode())
                                            else:
                                                rd.skip(w4)
                                    else:
                                        rs.skip(w3)
                            else:
                                rtt.skip(w2)
                    else:
                        rt.skip(wt)
            else:
                r.skip(w)
        return cls(name, et, tuple(shape))


@dataclass
class Graph:
    name: str
    nodes: list[Node]
    inputs: list[ValueInfo]
    outputs: list[ValueInfo]
    initializers: list[Tensor]
    doc: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        for n in self.nodes:
            out += _enc_bytes(1, n.encode())
        out += _enc_str(2, self.name)
        for t in self.initializers:
            out += _enc_bytes(5, t.encode())
        if self.doc:
            out += _enc_str(10, self.doc)
        for v in self.inputs:
            out += _enc_bytes(11, v.encode())
        for v in self.outputs:
            out += _enc_bytes(12, v.encode())
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Graph":
        r = _Reader(buf)
        g = cls("", [], [], [], [])
        while not r.eof():
            f, w = r.key()
            if f == 1:
                g.nodes.append(Node.decode(r.bytes_()))
            elif f == 2:
                g.name = r.bytes_().decode()
            elif f == 5:
                g.initializers.append(Tensor.decode(r.bytes_()))
            elif f == 10:
                g.doc = r.bytes_().decode()
            elif f == 11:
                g.inputs.append(ValueInfo.decode(r.bytes_()))
            elif f == 12:
                g.outputs.append(ValueInfo.decode(r.bytes_()))
            else:
                r.skip(w)
        return g


@dataclass
class Model:
    graph: Graph
    opset: int = 17            # LayerNormalization needs >= 17
    ir_version: int = 8
    producer: str = "mmidet_tpu_torch"
    doc: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        out += _enc_int(1, self.ir_version)
        out += _enc_str(2, self.producer)
        out += _enc_str(3, "0")
        if self.doc:
            out += _enc_str(6, self.doc)
        out += _enc_bytes(7, self.graph.encode())
        out += _enc_bytes(8, _enc_str(1, "") + _enc_int(2, self.opset))
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Model":
        r = _Reader(buf)
        m = cls(Graph("", [], [], [], []))
        while not r.eof():
            f, w = r.key()
            if f == 1:
                m.ir_version = r.svarint()
            elif f == 2:
                m.producer = r.bytes_().decode()
            elif f == 6:
                m.doc = r.bytes_().decode()
            elif f == 7:
                m.graph = Graph.decode(r.bytes_())
            elif f == 8:
                ro = _Reader(r.bytes_())
                while not ro.eof():
                    f2, w2 = ro.key()
                    if f2 == 2:
                        m.opset = ro.svarint()
                    else:
                        ro.skip(w2)
            else:
                r.skip(w)
        return m

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(self.encode())

    @classmethod
    def load(cls, path: str) -> "Model":
        with open(path, "rb") as fh:
            return cls.decode(fh.read())
