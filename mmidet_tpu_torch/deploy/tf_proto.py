"""Self-contained TF SavedModel codec (no ``tensorflow`` or
``google.protobuf`` package).

Counterpart of what ``tf.saved_model.save`` writes for the JAX package's
``export_savedmodel`` (``mmidet_tpu/deploy/export.py:50-86``).  It encodes
and decodes the subset of the schema a graph of plain ops needs:
``SavedModel``, ``MetaGraphDef`` (tag ``serve``), ``GraphDef``,
``NodeDef``, ``AttrValue``, ``TensorProto``, ``FunctionDef``,
``SignatureDef`` and the ``SavedObjectGraph``, and under ``variables/``
the tensor bundle that the loader restores: a table holding the one
string tensor ``_CHECKPOINTABLE_OBJECT_GRAPH``, checksummed with CRC-32C.

``write_savedmodel`` writes a ``tf_graph.TFGraph`` so that
``tf.saved_model.load`` gives ``loaded.serve(rgb[, ir])`` and
``loaded.signatures["serving_default"]``, as the JAX package's SavedModel
does: the forward is one function of plain TF ops (``Conv2D``,
``BatchMatMulV2``, ``Erf``, ...) whose weights are ``Const`` nodes; the
signature is a wrapper function that calls it and names its outputs
``output_0``, ``output_1``, ...  Every node carries ``_output_shapes``, so
that ``export_tflite`` reads each tensor's shape from the file.

``load`` decodes a SavedModel directory back into ``SavedModelFile``:
its functions, signatures and objects; ``tf_np.run`` executes it.

Field numbers follow TensorFlow's public ``.proto`` files
(``tensorflow/core/protobuf/{saved_model,meta_graph,saved_object_graph,
struct,trackable_object_graph,tensor_bundle}.proto``,
``tensorflow/core/framework/{graph,node_def,attr_value,tensor,
tensor_shape,function,op_def,versions}.proto``).
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass, field

import numpy as np

from mmidet_tpu_torch.deploy.pbwire import (VARINT, Writer, enc_varint,
                                            fields, varints)

# DataType
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT8, DT_STRING, DT_INT64, \
    DT_BOOL, DT_BFLOAT16, DT_HALF = 1, 2, 3, 4, 6, 7, 9, 10, 14, 19
_NP_OF = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
          DT_UINT8: np.uint8, DT_INT8: np.int8, DT_INT64: np.int64,
          DT_BOOL: np.bool_, DT_HALF: np.float16, DT_BFLOAT16: np.uint16}
_DT_OF = {"float32": DT_FLOAT, "bfloat16": DT_BFLOAT16, "int32": DT_INT32}

SAVED_MODEL_FILE = "saved_model.pb"
VARIABLES_DIR = "variables"
SIGNATURE_KEY = "serving_default"
GRAPH_PRODUCER = 1645      # a GraphDef version every TF 2.x reads

# which output argument each op names its (first) output by
OUT_ARG = {"Const": "output", "Identity": "output", "Conv2D": "output",
           "DepthwiseConv2dNative": "output", "BiasAdd": "output",
           "AddV2": "z", "Sub": "z", "Mul": "z", "RealDiv": "z",
           "SquaredDifference": "z", "Sigmoid": "y", "Relu": "activations",
           "Relu6": "activations", "LeakyRelu": "activations", "Erf": "y",
           "ConcatV2": "output", "MaxPool": "output",
           "ResizeNearestNeighbor": "resized_images", "Pad": "output",
           "PadV2": "output", "Reshape": "output", "Transpose": "y",
           "BatchMatMulV2": "output", "Softmax": "softmax", "Mean": "output",
           "Rsqrt": "y", "StridedSlice": "output", "Cast": "y", "Exp": "y",
           "Log": "y", "ReverseV2": "output", "SpaceToDepth": "output",
           "DepthToSpace": "output"}


# ------------------------------------------------------------ CRC-32C

def _crc_table() -> list[int]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        out.append(c)
    return out


_CRC = _crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), extending ``crc``."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc_mask(crc: int) -> int:
    """The stored form of a CRC (leveldb's and TF's ``crc32c::Mask``)."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


# ------------------------------------------------------- tensor bundle

_TABLE_MAGIC = struct.pack("<Q", 0xDB4775248B80FB57)
OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"


def _block(entries: list[tuple[bytes, bytes]], interval: int = 16) -> bytes:
    """One table block: keys prefix-compressed, a restart point every
    ``interval`` entries."""
    out, restarts, last = bytearray(), [], b""
    for i, (k, v) in enumerate(entries):
        shared = 0
        if i % interval:
            while (shared < min(len(k), len(last))
                   and k[shared] == last[shared]):
                shared += 1
        else:
            restarts.append(len(out))
        out += (enc_varint(shared) + enc_varint(len(k) - shared)
                + enc_varint(len(v)) + k[shared:] + v)
        last = k
    for r in restarts or [0]:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts) or 1)
    return bytes(out)


def _successor(key: bytes) -> bytes:
    """The shortest key at or after ``key`` (leveldb's
    ``FindShortSuccessor``), the index block's key of the last block."""
    for i, b in enumerate(key):
        if b != 0xFF:
            return key[:i] + bytes([b + 1])
    return key


def _table(entries: list[tuple[bytes, bytes]]) -> bytes:
    """An immutable sorted table (leveldb's format, as TF's tensor bundle
    index is): one data block, an empty metaindex block, the index block
    and the footer; each block followed by its type (0, uncompressed) and
    masked CRC-32C."""
    out = bytearray()

    def put(block: bytes) -> bytes:
        handle = enc_varint(len(out)) + enc_varint(len(block))
        trailer = b"\x00"
        out.extend(block + trailer + struct.pack(
            "<I", crc_mask(crc32c(block + trailer))))
        return handle
    data = put(_block(entries))
    meta = put(_block([]))
    index = put(_block([(_successor(entries[-1][0]), data)]))
    footer = meta + index
    out += footer + b"\x00" * (40 - len(footer)) + _TABLE_MAGIC
    return bytes(out)


def bundle(object_graph: bytes) -> tuple[bytes, bytes]:
    """(variables.index, variables.data-00000-of-00001) of a checkpoint
    holding only the object graph: a scalar string tensor, laid out as
    TF's ``WriteStringTensor`` lays it (varint length, masked CRC of the
    length, the bytes)."""
    n = len(object_graph)
    crc = crc32c(struct.pack("<I", n))
    len_crc = struct.pack("<I", crc_mask(crc))
    crc = crc32c(object_graph, crc32c(len_crc, crc))
    data = enc_varint(n) + len_crc + object_graph
    header = Writer().int(1, 1).msg(3, Writer().int(1, 1))  # 1 shard, v1
    entry = (Writer().int(1, DT_STRING).msg(2, Writer()).int(5, len(data))
             .fixed32(6, crc_mask(crc)))
    index = _table([(b"", header.getvalue()),
                    (OBJECT_GRAPH_KEY.encode(), entry.getvalue())])
    return index, data


# ------------------------------------------------------- proto encoders

def shape_proto(shape) -> Writer:
    w = Writer()
    for d in shape:
        w.msg(2, Writer().int(1, int(d)))
    return w


def tensor_proto(arr: np.ndarray, dtype: int) -> Writer:
    arr = np.asarray(arr, order="C")     # (ascontiguousarray makes 0-d 1-d)
    w = Writer().int(1, dtype).msg(2, shape_proto(arr.shape))
    if arr.size:
        w.bytes(4, memoryview(arr).cast("B"))            # tensor_content
    return w


def attr(kind: str, v) -> Writer:
    """An ``AttrValue``: ``kind`` is s, i, f, b, type, shape, tensor,
    func, or list_i, list_type, list_shape."""
    w = Writer()
    if kind == "s":
        return w.bytes(2, v if isinstance(v, bytes) else v.encode())
    if kind == "i":
        return w.int(3, v)
    if kind == "f":
        return w.float(4, v)
    if kind == "b":
        return w.int(5, int(bool(v)))
    if kind == "type":
        return w.int(6, v)
    if kind == "shape":
        return w.msg(7, shape_proto(v))
    if kind == "tensor":
        return w.msg(8, tensor_proto(*v))
    if kind == "func":
        return w.msg(10, Writer().str(1, v))
    lst = Writer()
    if kind == "list_i":
        if v:
            lst.packed(3, v)
    elif kind == "list_type":
        if v:
            lst.packed(6, v)
    elif kind == "list_shape":
        for s in v:
            lst.msg(7, shape_proto(s))
    else:
        raise ValueError(f"attr kind {kind!r}")
    return w.msg(1, lst)


def _str_map(fieldno: int, out: Writer, items) -> None:
    """map<string, message> entries (key 1, value 2)."""
    for k, v in items:
        out.msg(fieldno, Writer().str(1, k).msg(2, v))


@dataclass
class TFNode:
    name: str
    op: str
    inputs: list[str]
    attrs: dict = field(default_factory=dict)    # name -> (kind, value)

    def encode(self) -> Writer:
        w = Writer().str(1, self.name).str(2, self.op)
        for s in self.inputs:
            w.str(3, s)
        _str_map(5, w, ((k, attr(*v)) for k, v in sorted(self.attrs.items())))
        return w


@dataclass
class TFFunction:
    name: str
    args: list[tuple[str, int]]              # (name, DataType)
    outputs: list[tuple[str, int]]
    nodes: list[TFNode]
    ret: dict[str, str]                      # output arg -> node output
    arg_shapes: list | None = None

    def encode(self) -> Writer:
        sig = Writer().str(1, self.name)
        for n, t in self.args:
            sig.msg(2, Writer().str(1, n).int(3, t))
        for n, t in self.outputs:
            sig.msg(3, Writer().str(1, n).int(3, t))
        w = Writer().msg(1, sig)
        for node in self.nodes:
            w.msg(3, node.encode())
        for k, v in self.ret.items():
            w.msg(4, Writer().str(1, k).str(2, v))
        for i, (n, _) in enumerate(self.args):
            attrs = Writer()
            _str_map(1, attrs, [("_user_specified_name", attr("s", n))] + (
                [("_output_shapes", attr("list_shape",
                                         [self.arg_shapes[i]]))]
                if self.arg_shapes else []))
            w.msg(7, Writer().int(1, i).msg(2, attrs))
        return w


# ---------------------------------------------- structured values (struct)

def sv_none() -> Writer:
    return Writer().msg(1, Writer())


def sv_str(s: str) -> Writer:
    return Writer().str(13, s)


def sv_list(items: list[Writer], fieldno: int = 51) -> Writer:
    body = Writer()
    for it in items:
        body.msg(1, it)
    return Writer().msg(fieldno, body)


def sv_tuple(items: list[Writer]) -> Writer:
    return sv_list(items, 52)


def sv_dict(items: list[tuple[str, Writer]]) -> Writer:
    body = Writer()
    for k, v in items:
        body.msg(1, Writer().str(1, k).msg(2, v))
    return Writer().msg(53, body)


def sv_spec(name: str, shape, dtype: int) -> Writer:
    return Writer().msg(33, Writer().str(1, name).msg(2, shape_proto(shape))
                        .int(3, dtype))


def full_arg_spec(args: list[str], kwonly: list[str]) -> Writer:
    pairs = [("args", sv_list([sv_str(a) for a in args])),
             ("varargs", sv_none()), ("varkw", sv_none()),
             ("defaults", sv_none()),
             ("kwonlyargs", sv_list([sv_str(a) for a in kwonly])),
             ("kwonlydefaults", sv_none()),
             ("annotations", Writer().msg(53, Writer()))]
    body = Writer().str(1, "FullArgSpec")
    for k, v in pairs:
        body.msg(2, Writer().str(1, k).msg(2, v))
    return Writer().msg(54, body)


def function_spec(args: list[str], kwonly: list[str],
                  input_signature: Writer | None) -> Writer:
    return Writer().msg(1, full_arg_spec(args, kwonly)).msg(
        5, input_signature or sv_none())


# ---------------------------------------------------- TFGraph -> nodes

def pair(v) -> tuple[int, int]:
    """A graph op's ``stride`` (an int or (h, w)) as (h, w)."""
    return (int(v), int(v)) if np.isscalar(v) else (int(v[0]), int(v[1]))


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _Nodes:
    """The body function's nodes, with ``_output_shapes`` on each."""

    def __init__(self, graph):
        self.g = graph
        self.nodes: list[TFNode] = []
        self.ref = {name: name for name, _, _ in graph.inputs}

    def node(self, name, op, inputs, shape, **attrs) -> str:
        attrs["_output_shapes"] = ("list_shape", [shape])
        self.nodes.append(TFNode(name, op, [self.ref.get(i, i)
                                            for i in inputs], attrs))
        ref = f"{name}:{OUT_ARG[op]}:0"
        return ref

    def const(self, name, arr, dtype=DT_FLOAT) -> str:
        arr = np.asarray(arr, _NP_OF[dtype])
        return self.node(name, "Const", [], arr.shape, dtype=("type", dtype),
                         value=("tensor", (arr, dtype)))

    def ints(self, name, vals) -> str:
        return self.const(name, np.asarray(vals, np.int32), DT_INT32)


def _padded(n: _Nodes, name, x, xshape, pads, k, s):
    """(input ref, padding) of a conv with strides ``s`` (h, w): SAME or
    VALID where one of them gives ``pads`` (top, bottom, left, right),
    else a ``Pad`` node and VALID."""
    t, b, le, r = pads
    if not any(pads):
        return x, "VALID"
    if ((t, b) == _same_pads(xshape[1], k[0], s[0])
            and (le, r) == _same_pads(xshape[2], k[1], s[1])):
        return x, "SAME"
    shape = (xshape[0], xshape[1] + t + b, xshape[2] + le + r, xshape[3])
    y = n.node(f"{name}_pad", "Pad", [x, n.ints(f"{name}_paddings", [
        [0, 0], [t, b], [le, r], [0, 0]])], shape, T=("type", DT_FLOAT),
        Tpaddings=("type", DT_INT32))
    return y, "VALID"


_BINARY = {"add": "AddV2", "sub": "Sub", "mul": "Mul", "div": "RealDiv",
           "squared_difference": "SquaredDifference"}
_UNARY = {"sigmoid": "Sigmoid", "relu": "Relu", "rsqrt": "Rsqrt",
          "softmax": "Softmax", "exp": "Exp", "log": "Log"}
F32 = ("type", DT_FLOAT)


def body_nodes(graph) -> list[TFNode]:
    """The nodes of the body function of a ``tf_graph.TFGraph``."""
    n = _Nodes(graph)
    for name, arr in graph.consts.items():
        n.ref[name] = n.const(name, arr)
    shapes = graph.shapes
    for op in graph.ops:
        out, k, a = op.output, op.kind, op.attrs
        shape = shapes[out]
        ins = [n.ref[i] for i in op.inputs]
        if k in ("conv2d", "depthwise_conv2d"):
            kshape = shapes[op.inputs[1]][:2]
            sh, sw = pair(a["stride"])
            x, padding = _padded(n, out, ins[0], shapes[op.inputs[0]],
                                 a["pads"], kshape, (sh, sw))
            tf_op = "Conv2D" if k == "conv2d" else "DepthwiseConv2dNative"
            name = f"{out}_conv" if len(ins) > 2 else out
            y = n.node(name, tf_op, [x, ins[1]], shape, T=F32,
                       strides=("list_i", [1, sh, sw, 1]),
                       padding=("s", padding), data_format=("s", "NHWC"),
                       dilations=("list_i", [1, 1, 1, 1]))
            if len(ins) > 2:
                y = n.node(out, "BiasAdd", [y, ins[2]], shape, T=F32,
                           data_format=("s", "NHWC"))
        elif k == "matmul":
            name = f"{out}_matmul" if len(ins) > 2 else out
            y = n.node(name, "BatchMatMulV2", ins[:2], shape, T=F32,
                       adj_x=("b", False), adj_y=("b", False))
            if len(ins) > 2:
                y = n.node(out, "BiasAdd", [y, ins[2]], shape, T=F32,
                           data_format=("s", "NHWC"))
        elif k in _BINARY:
            y = n.node(out, _BINARY[k], ins, shape, T=F32)
        elif k in _UNARY:
            y = n.node(out, _UNARY[k], ins, shape, T=F32)
        elif k == "leaky_relu":
            y = n.node(out, "LeakyRelu", ins, shape, T=F32,
                       alpha=("f", a["alpha"]))
        elif k == "hardswish":   # x * relu6(x + 3) / 6
            r = n.node(f"{out}_relu6", "Relu6", [n.node(
                f"{out}_plus3", "AddV2", [ins[0], n.const(f"{out}_3", 3.0)],
                shape, T=F32)], shape, T=F32)
            y = n.node(f"{out}_xr", "Mul", [ins[0], r], shape, T=F32)
            y = n.node(out, "Mul", [y, n.const(f"{out}_sixth", 1.0 / 6.0)],
                       shape, T=F32)
        elif k == "gelu":        # 0.5 * x * (1 + erf(x / sqrt(2)))
            e = n.node(f"{out}_erf", "Erf", [n.node(
                f"{out}_scaled", "Mul", [ins[0], n.const(
                    f"{out}_rsqrt2", 1.0 / math.sqrt(2.0))], shape, T=F32)],
                shape, T=F32)
            e = n.node(f"{out}_plus1", "AddV2",
                       [e, n.const(f"{out}_1", 1.0)], shape, T=F32)
            y = n.node(f"{out}_xe", "Mul", [ins[0], e], shape, T=F32)
            y = n.node(out, "Mul", [y, n.const(f"{out}_half", 0.5)], shape,
                       T=F32)
        elif k == "concat":
            y = n.node(out, "ConcatV2", ins + [n.ints(
                f"{out}_axis", a["axis"])], shape, N=("i", len(ins)),
                T=F32, Tidx=("type", DT_INT32))
        elif k == "max_pool":
            kk, s = a["k"], a.get("stride", 1)
            y = n.node(out, "MaxPool", ins, shape, T=F32,
                       ksize=("list_i", [1, kk, kk, 1]),
                       strides=("list_i", [1, s, s, 1]),
                       padding=("s", a.get("padding", "SAME")),
                       data_format=("s", "NHWC"))
        elif k == "resize_nearest":
            y = n.node(out, "ResizeNearestNeighbor", ins + [n.ints(
                f"{out}_size", shape[1:3])], shape, T=F32,
                align_corners=("b", False), half_pixel_centers=("b", False))
        elif k == "pad" and "value" in a:     # a max pool's -inf border
            y = n.node(out, "PadV2", ins + [
                n.ints(f"{out}_paddings", a["pads"]),
                n.const(f"{out}_value", np.float32(a["value"]))], shape,
                T=F32, Tpaddings=("type", DT_INT32))
        elif k == "pad":
            y = n.node(out, "Pad", ins + [n.ints(f"{out}_paddings",
                                                 a["pads"])], shape, T=F32,
                       Tpaddings=("type", DT_INT32))
        elif k == "reverse":
            y = n.node(out, "ReverseV2", ins + [n.ints(f"{out}_axis", [
                a["axis"] % len(shape)])], shape, T=F32,
                Tidx=("type", DT_INT32))
        elif k in ("space_to_depth", "depth_to_space"):
            y = n.node(out, "SpaceToDepth" if k == "space_to_depth"
                       else "DepthToSpace", ins, shape, T=F32,
                       block_size=("i", a["block"]),
                       data_format=("s", "NHWC"))
        elif k == "reshape":
            y = n.node(out, "Reshape", ins + [n.ints(f"{out}_shape", shape)],
                       shape, T=F32, Tshape=("type", DT_INT32))
        elif k == "transpose":
            y = n.node(out, "Transpose", ins + [n.ints(f"{out}_perm",
                                                       a["perm"])], shape,
                       T=F32, Tperm=("type", DT_INT32))
        elif k == "mean":
            y = n.node(out, "Mean", ins + [n.ints(f"{out}_axes", [
                ax % len(shape) for ax in a["axes"]])], shape, T=F32,
                keep_dims=("b", True), Tidx=("type", DT_INT32))
        elif k == "strided_slice":
            y = n.node(out, "StridedSlice", ins + [
                n.ints(f"{out}_begin", a["begin"]),
                n.ints(f"{out}_end", a["end"]),
                n.ints(f"{out}_strides", a["strides"])], shape, T=F32,
                Index=("type", DT_INT32), begin_mask=("i", 0),
                end_mask=("i", 0), ellipsis_mask=("i", 0),
                new_axis_mask=("i", 0), shrink_axis_mask=("i", 0))
        elif k == "cast":
            src = _DT_OF[graph.dtypes[op.inputs[0]]]
            y = n.node(out, "Cast", ins, shape, SrcT=("type", src),
                       DstT=("type", _DT_OF[a["to"]]), Truncate=("b", False))
        else:
            raise ValueError(f"SavedModel export: no TF form for {k!r}")
        n.ref[out] = y
    for i, o in enumerate(graph.outputs):
        suffix = f"_{i}" if i else ""
        n.node(f"Identity{suffix}", "Identity", [n.ref[o]], shapes[o], T=F32)
    return n.nodes


# ------------------------------------------------------------- writing

def _names(n: int, stem: str) -> list[str]:
    return [stem + (f"_{i}" if i else "") for i in range(n)]


def savedmodel_bytes(graph) -> tuple[bytes, bytes]:
    """(saved_model.pb, the checkpoint's object graph) of a ``TFGraph``."""
    in_names = [name for name, _, _ in graph.inputs]
    in_dt = {name: _DT_OF[dt] for name, _, dt in graph.inputs}
    in_shape = {name: shape for name, shape, _ in graph.inputs}
    outs = [(f"output_{i}", graph.shapes[o])
            for i, o in enumerate(graph.outputs)]
    body_name, sig_name = "__inference_serve_1", \
        "__inference_signature_wrapper_2"
    ids = _names(len(outs), "identity")
    body = TFFunction(
        body_name, [(n, in_dt[n]) for n in in_names],
        [(i, DT_FLOAT) for i in ids], body_nodes(graph),
        {i: f"Identity{s}:output:0" for i, s in zip(
            ids, [""] + [f"_{j}" for j in range(1, len(ids))])},
        arg_shapes=[in_shape[n] for n in in_names])
    # the signature wrapper: keyword arguments in sorted order, one
    # Identity an output, named by the output keys' sorted order
    kw = sorted(in_names)
    call = TFNode("PartitionedCall", "PartitionedCall", list(in_names), {
        "Tin": ("list_type", [in_dt[n] for n in in_names]),
        "Tout": ("list_type", [DT_FLOAT] * len(outs)),
        "f": ("func", body_name),
        "_output_shapes": ("list_shape", [s for _, s in outs])})
    idn = [TFNode(f"Identity{s}", "Identity",
                  [f"PartitionedCall:output:{j}"],
                  {"T": F32, "_output_shapes": ("list_shape", [outs[j][1]])})
           for j, s in enumerate([""] + [f"_{j}" for j in
                                         range(1, len(outs))])]
    sig = TFFunction(sig_name, [(n, in_dt[n]) for n in kw],
                     [(i, DT_FLOAT) for i in ids], [call] + idn,
                     {i: f"{nd.name}:output:0" for i, nd in zip(ids, idn)},
                     arg_shapes=[in_shape[n] for n in kw])
    library = Writer().msg(1, body.encode()).msg(1, sig.encode())
    # the top-level graph: the signature's placeholders and its call, as
    # TF Serving reads them through the SignatureDef
    top = Writer()
    for name in kw:
        top.msg(1, TFNode(f"serving_default_{name}", "Placeholder", [], {
            "dtype": ("type", in_dt[name]),
            "shape": ("shape", in_shape[name]),
            "_output_shapes": ("list_shape", [in_shape[name]])}).encode())
    top.msg(1, TFNode("PartitionedCall", "PartitionedCall",
                      [f"serving_default_{n}" for n in kw], {
                          "Tin": ("list_type", [in_dt[n] for n in kw]),
                          "Tout": ("list_type", [DT_FLOAT] * len(outs)),
                          "f": ("func", sig_name),
                          "_output_shapes": ("list_shape",
                                             [s for _, s in outs])}).encode())
    top.msg(2, library).msg(4, Writer().int(1, GRAPH_PRODUCER).int(2, 12))

    def info(name, dt, shape) -> Writer:
        return Writer().str(1, name).int(2, dt).msg(3, shape_proto(shape))
    sigdef = Writer()
    _str_map(1, sigdef, [(n, info(f"serving_default_{n}:0", in_dt[n],
                                  in_shape[n])) for n in kw])
    _str_map(2, sigdef, [(k, info(f"PartitionedCall:{j}", DT_FLOAT, s))
                         for j, (k, s) in enumerate(outs)])
    sigdef.str(3, "tensorflow/serving/predict")

    specs = {n: sv_spec(n, in_shape[n], in_dt[n]) for n in in_names}
    out_specs = [sv_spec(k, s, DT_FLOAT) for k, s in outs]
    serve_in = sv_tuple([sv_tuple([specs[n] for n in in_names]),
                         sv_dict([])])
    serve_out = out_specs[0] if len(outs) == 1 else sv_tuple(
        [sv_spec("unknown", s, DT_FLOAT) for _, s in outs])
    sig_in = sv_tuple([sv_tuple([]), sv_dict([(n, specs[n]) for n in kw])])
    sig_out = sv_dict([(k, o) for (k, _), o in zip(outs, out_specs)])
    user = Writer().str(1, "_generic_user_object").msg(
        2, Writer().int(1, 1).int(2, 1))
    sigmap = Writer().str(1, "signature_map").msg(
        2, Writer().int(1, 1).int(2, 1))
    children = [[("serve", 1), ("signatures", 2)], [("trace_0", 3)],
                [(SIGNATURE_KEY, 4)], [], []]
    objs = [
        Writer().msg(4, user),
        Writer().msg(6, Writer().str(1, body_name).msg(2, function_spec(
            in_names, [], sv_tuple([specs[n] for n in in_names])))),
        Writer().msg(4, sigmap),
        Writer().msg(8, _bare(body_name, in_names, len(in_names),
                              function_spec(in_names, [], None))),
        Writer().msg(8, _bare(sig_name, kw, 0, function_spec([], kw, None))),
    ]
    og = Writer()
    for obj, kids in zip(objs, children):
        node = Writer()
        for name, i in kids:
            node.msg(1, Writer().int(1, i).str(2, name))
        node.parts.extend(obj.parts)
        node.n += obj.n
        og.msg(1, node)
    for name, cin, cout in ((sig_name, sig_in, sig_out),
                            (body_name, serve_in, serve_out)):
        og.msg(2, Writer().str(1, name).msg(2, Writer().msg(3, cin)
                                            .msg(4, cout)))
    meta_info = Writer().str(4, "serve").str(5, "mmidet_tpu_torch")
    meta = Writer().msg(1, meta_info).msg(2, top)
    _str_map(5, meta, [(SIGNATURE_KEY, sigdef)])
    meta.msg(7, og)
    sm = Writer().int(1, 1).msg(2, meta)
    # the checkpoint's object graph: the same objects and children, none
    # holding a value
    ckpt = Writer()
    for kids in children:
        node = Writer()
        for name, i in kids:
            node.msg(1, Writer().int(1, i).str(2, name))
        ckpt.msg(1, node.msg(5, Writer()))
    return sm.getvalue(), ckpt.getvalue()


def _bare(name: str, keywords: list[str], positional: int,
          spec: Writer) -> Writer:
    w = Writer().str(1, name)
    for k in keywords:
        w.str(2, k)
    if positional:
        w.int(3, positional)
    return w.msg(4, spec)


def write_savedmodel(path: str, graph) -> str:
    """Write ``graph`` (a ``tf_graph.TFGraph``) as a SavedModel directory
    at ``path``: ``saved_model.pb`` and ``variables/``."""
    pb, object_graph = savedmodel_bytes(graph)
    if len(pb) >= 2 ** 31:
        raise ValueError(f"SavedModel of {len(pb) / 1e9:.2f} GB: over "
                         "protobuf's 2 GB limit for one message")
    os.makedirs(os.path.join(path, VARIABLES_DIR), exist_ok=True)
    with open(os.path.join(path, SAVED_MODEL_FILE), "wb") as fh:
        fh.write(pb)
    index, data = bundle(object_graph)
    stem = os.path.join(path, VARIABLES_DIR, "variables")
    with open(stem + ".index", "wb") as fh:
        fh.write(index)
    with open(stem + ".data-00000-of-00001", "wb") as fh:
        fh.write(data)
    return path


@dataclass
class Signature:
    inputs: dict[str, tuple[str, int, tuple]]     # key -> (tensor, dt, shape)
    outputs: dict[str, tuple[str, int, tuple]]
    method: str = ""


# ------------------------------------------------------------- decoding

def _s(b) -> str:
    return str(b, "utf-8")


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _ints(wire: int, v) -> list[int]:
    """A repeated integer field's values: one varint, or packed."""
    return [_signed(x) for x in ([v] if wire == VARINT else varints(v))]


def _last(buf) -> dict:
    """The message's fields by number (the last of each, as protobuf
    reads a singular field)."""
    return {f: v for f, _, v in fields(buf)}


def decode_shape(buf) -> tuple:
    return tuple(_signed(_last(d).get(1, 0)) for f, _, d in fields(buf)
                 if f == 2)


def decode_tensor(buf) -> np.ndarray:
    """A ``TensorProto`` as the writer lays it out: its bytes in
    ``tensor_content`` (none for an empty tensor)."""
    m = _last(buf)
    return np.frombuffer(m.get(4, b""), _NP_OF[m.get(1, DT_FLOAT)]).reshape(
        decode_shape(m.get(2, b"")))


def decode_attr(buf):
    for f, w, v in fields(buf):
        if f == 1:                                        # list
            out = []
            for f2, w2, v2 in fields(v):
                if f2 == 2:
                    out.append(bytes(v2))
                elif f2 in (3, 6):                        # i, type
                    out.extend(_ints(w2, v2))
                elif f2 == 7:
                    out.append(decode_shape(v2))
            return out
        if f == 2:
            return bytes(v)
        if f == 3:
            return _signed(v)
        if f == 4:
            return struct.unpack("<f", v)[0]
        if f in (5, 6):                                   # b, type
            return bool(v) if f == 5 else v
        if f == 7:
            return decode_shape(v)
        if f == 8:
            return decode_tensor(v)
        if f == 10:
            return _s(_last(v)[1])
    return None


def _entry(buf, value) -> tuple:
    """A map entry: (key, ``value(its value's bytes)``)."""
    m = _last(buf)
    return _s(m.get(1, b"")), value(m.get(2, b""))


def decode_node(buf) -> TFNode:
    n = TFNode("", "", [])
    for f, _, v in fields(buf):
        if f == 1:
            n.name = _s(v)
        elif f == 2:
            n.op = _s(v)
        elif f == 3:
            n.inputs.append(_s(v))
        elif f == 5:
            k, a = _entry(v, decode_attr)
            n.attrs[k] = a
    return n


def _argdef(buf) -> tuple[str, int]:
    m = _last(buf)
    return _s(m.get(1, b"")), m.get(3, 0)


def decode_function(buf) -> TFFunction:
    fn = TFFunction("", [], [], [], {})
    for f, _, v in fields(buf):
        if f == 1:                                        # the OpDef
            for f2, _, v2 in fields(v):
                if f2 == 1:
                    fn.name = _s(v2)
                elif f2 in (2, 3):
                    (fn.args if f2 == 2 else fn.outputs).append(_argdef(v2))
        elif f == 3:
            fn.nodes.append(decode_node(v))
        elif f == 4:
            k, r = _entry(v, _s)
            fn.ret[k] = r
    return fn


def _tensor_info(buf) -> tuple[str, int, tuple]:
    m = _last(buf)
    return _s(m.get(1, b"")), m.get(2, 0), decode_shape(m.get(3, b""))


def _decode_signature(buf) -> Signature:
    sig = Signature({}, {})
    for f, _, v in fields(buf):
        if f in (1, 2):
            k, info = _entry(v, _tensor_info)
            (sig.inputs if f == 1 else sig.outputs)[k] = info
        elif f == 3:
            sig.method = _s(v)
    return sig


@dataclass
class SavedModelFile:
    """A decoded SavedModel: its functions by name, top-level nodes,
    signatures, tags, and for each object of the object graph its
    children by name and the concrete function names it holds."""
    functions: dict[str, TFFunction]
    graph_nodes: list[TFNode]
    signatures: dict[str, Signature]
    tags: list[str]
    objects: list[tuple[dict[str, int], list[str]]]

    def serve_function(self) -> TFFunction:
        """The body the root object's ``serve`` holds."""
        fn_id = self.objects[0][0]["serve"]
        return self.functions[self.objects[fn_id][1][0]]

    def signature_function(self, key: str = SIGNATURE_KEY) -> TFFunction:
        sig_map = self.objects[self.objects[0][0]["signatures"]][0]
        return self.functions[self.objects[sig_map[key]][1][0]]


def _decode_object(buf) -> tuple[dict[str, int], list[str]]:
    children, fns = {}, []
    for f, _, v in fields(buf):
        if f == 1:
            m = _last(v)
            children[_s(m.get(2, b""))] = m.get(1, 0)
        elif f in (6, 8):            # function / bare_concrete_function
            fns += [_s(v2) for f2, _, v2 in fields(v) if f2 == 1]
    return children, fns


def decode_savedmodel(buf) -> SavedModelFile:
    """The first MetaGraphDef of a ``saved_model.pb``."""
    out = SavedModelFile({}, [], {}, [], [])
    meta = next(v for f, _, v in fields(memoryview(buf)) if f == 2)
    for f, _, v in fields(meta):
        if f == 1:
            out.tags += [_s(t) for f2, _, t in fields(v) if f2 == 4]
        elif f == 2:
            for f2, _, v2 in fields(v):
                if f2 == 1:
                    out.graph_nodes.append(decode_node(v2))
                elif f2 == 2:
                    for fn in (decode_function(v3) for f3, _, v3 in
                               fields(v2) if f3 == 1):
                        out.functions[fn.name] = fn
        elif f == 5:
            k, sig = _entry(v, _decode_signature)
            out.signatures[k] = sig
        elif f == 7:
            out.objects = [_decode_object(v2) for f2, _, v2 in fields(v)
                           if f2 == 1]
    return out


def load(path: str) -> SavedModelFile:
    """Decode the SavedModel directory at ``path``."""
    with open(os.path.join(path, SAVED_MODEL_FILE), "rb") as fh:
        return decode_savedmodel(fh.read())
