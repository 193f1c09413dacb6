"""Self-contained TFLite flatbuffer codec and SavedModel converter (no
``tensorflow`` or ``flatbuffers`` package).

Counterpart of ``export_tflite`` in ``mmidet_tpu/deploy/export.py:89-111``
(``TFLiteConverter.from_saved_model``).  It writes and reads the subset of
TFLite's schema (``tensorflow/lite/schema/schema.fbs``) that the port's
graphs need: ``Model`` (version 3, file identifier ``TFL3``) with its
``OperatorCode``s, one ``SubGraph`` of ``Tensor``s and ``Operator``s with
their builtin options, the ``Buffer``s (buffer 0 empty, one a constant),
and a ``SignatureDef`` ``serving_default``, so that
``Interpreter.get_signature_runner("serving_default")`` works.

``convert`` maps the body function of a SavedModel that ``tf_proto``
wrote, decoded, node by node onto TFLite builtins: every operator is a
builtin, none ``CUSTOM`` and none a TF op (Flex).  Two node groups become
one builtin each, as TF's own converter fuses them: a bias add after a
conv or a constant-weight matmul (its bias input), and the exact GELU's
``x * (erf(x / sqrt(2)) + 1) * 0.5`` (``GELU``, approximate false).  A node
with no builtin raises ``ValueError`` naming it.

The buffer is laid out front to back: a table's vtable just before it,
its children after it, each offset patched once the child is placed.
Scalars sit at their natural alignment and constant data at 16 bytes, as
the verifier of TFLite's runtime wants.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

IDENTIFIER = b"TFL3"
SCHEMA_VERSION = 3
SIGNATURE_KEY = "serving_default"

# BuiltinOperator
ADD, CONCATENATION, CONV_2D, DEPTH_TO_SPACE, DEPTHWISE_CONV_2D, \
    FULLY_CONNECTED, LOGISTIC, MAX_POOL_2D, MUL, RELU, RELU6, RESHAPE, \
    SOFTMAX, SPACE_TO_DEPTH, PAD, TRANSPOSE, MEAN, SUB, DIV, STRIDED_SLICE, \
    EXP, PADV2, LOG, RSQRT, RESIZE_NEAREST_NEIGHBOR, LEAKY_RELU, \
    SQUARED_DIFFERENCE, REVERSE_V2, BATCH_MATMUL, GELU = (
        0, 2, 3, 5, 4, 9, 14, 17, 18, 19, 21, 22, 25, 26, 34, 39, 40, 41,
        42, 45, 47, 60, 73, 76, 97, 98, 99, 105, 126, 150)
PLACEHOLDER_FOR_GREATER_OP_CODES = 127
BUILTIN_NAMES = {
    ADD: "ADD", CONCATENATION: "CONCATENATION", CONV_2D: "CONV_2D",
    DEPTHWISE_CONV_2D: "DEPTHWISE_CONV_2D",
    FULLY_CONNECTED: "FULLY_CONNECTED", LOGISTIC: "LOGISTIC",
    MAX_POOL_2D: "MAX_POOL_2D", MUL: "MUL", RELU: "RELU", RELU6: "RELU6",
    RESHAPE: "RESHAPE", SOFTMAX: "SOFTMAX", PAD: "PAD",
    TRANSPOSE: "TRANSPOSE", MEAN: "MEAN", SUB: "SUB", DIV: "DIV",
    STRIDED_SLICE: "STRIDED_SLICE", RSQRT: "RSQRT",
    RESIZE_NEAREST_NEIGHBOR: "RESIZE_NEAREST_NEIGHBOR",
    LEAKY_RELU: "LEAKY_RELU", SQUARED_DIFFERENCE: "SQUARED_DIFFERENCE",
    BATCH_MATMUL: "BATCH_MATMUL", GELU: "GELU",
    DEPTH_TO_SPACE: "DEPTH_TO_SPACE", SPACE_TO_DEPTH: "SPACE_TO_DEPTH",
    EXP: "EXP", PADV2: "PADV2", LOG: "LOG", REVERSE_V2: "REVERSE_V2"}

# TensorType
FLOAT32, INT32 = 0, 2
_NP_OF = {FLOAT32: np.float32, INT32: np.int32}
SAME, VALID = 0, 1

# BuiltinOptions: union index, then (field, slot, struct format) per field
OPTIONS = {
    "Conv2DOptions": (1, [("padding", 0, "b"), ("stride_w", 1, "i"),
                          ("stride_h", 2, "i"), ("fused_activation", 3, "b"),
                          ("dilation_w", 4, "i"), ("dilation_h", 5, "i")]),
    "DepthwiseConv2DOptions": (2, [
        ("padding", 0, "b"), ("stride_w", 1, "i"), ("stride_h", 2, "i"),
        ("depth_multiplier", 3, "i"), ("fused_activation", 4, "b"),
        ("dilation_w", 5, "i"), ("dilation_h", 6, "i")]),
    "Pool2DOptions": (5, [("padding", 0, "b"), ("stride_w", 1, "i"),
                          ("stride_h", 2, "i"), ("filter_width", 3, "i"),
                          ("filter_height", 4, "i"),
                          ("fused_activation", 5, "b")]),
    "FullyConnectedOptions": (8, [("fused_activation", 0, "b"),
                                  ("weights_format", 1, "b"),
                                  ("keep_num_dims", 2, "?")]),
    "SoftmaxOptions": (9, [("beta", 0, "f")]),
    "ConcatenationOptions": (10, [("axis", 0, "i"),
                                  ("fused_activation", 1, "b")]),
    "AddOptions": (11, [("fused_activation", 0, "b")]),
    "ReshapeOptions": (17, [("new_shape", 0, "[i")]),
    "SpaceToDepthOptions": (19, [("block_size", 0, "i")]),
    "MulOptions": (21, [("fused_activation", 0, "b")]),
    "PadOptions": (22, []),
    "TransposeOptions": (26, []),
    "ReducerOptions": (27, [("keep_dims", 0, "?")]),
    "SubOptions": (28, [("fused_activation", 0, "b")]),
    "DivOptions": (29, [("fused_activation", 0, "b")]),
    "StridedSliceOptions": (32, [("begin_mask", 0, "i"), ("end_mask", 1, "i"),
                                 ("ellipsis_mask", 2, "i"),
                                 ("new_axis_mask", 3, "i"),
                                 ("shrink_axis_mask", 4, "i")]),
    "PadV2Options": (43, []),
    "ResizeNearestNeighborOptions": (74, [("align_corners", 0, "?"),
                                          ("half_pixel_centers", 1, "?")]),
    "LeakyReluOptions": (75, [("alpha", 0, "f")]),
    "SquaredDifferenceOptions": (76, []),
    "ReverseV2Options": (81, []),
    "DepthToSpaceOptions": (94, [("block_size", 0, "i")]),
    "BatchMatMulOptions": (101, [("adj_x", 0, "?"), ("adj_y", 1, "?")]),
    "GeluOptions": (116, [("approximate", 0, "?")]),
}
_OPTIONS_BY_TYPE = {t: (name, fields) for name, (t, fields) in
                    OPTIONS.items()}


@dataclass
class Tensor:
    shape: tuple
    type: int
    buffer: int
    name: str


@dataclass
class Operator:
    opcode: int                      # index into Model.opcodes
    inputs: list[int]
    outputs: list[int]
    options_name: str = ""
    options: dict = field(default_factory=dict)


@dataclass
class Model:
    """One subgraph, its buffers (``bytes``; buffer 0 empty) and one
    signature (``inputs``/``outputs``: name -> tensor index)."""
    opcodes: list[int]               # builtin codes
    tensors: list[Tensor]
    inputs: list[int]
    outputs: list[int]
    operators: list[Operator]
    buffers: list[bytes]
    sig_inputs: dict[str, int]
    sig_outputs: dict[str, int]
    signature_key: str = SIGNATURE_KEY
    description: str = "mmidet_tpu_torch"
    version: int = SCHEMA_VERSION

    def array(self, t: int) -> np.ndarray | None:
        """The constant data of tensor ``t``, or None."""
        ten = self.tensors[t]
        data = self.buffers[ten.buffer]
        if not data:
            return None
        return np.frombuffer(data, _NP_OF[ten.type]).reshape(ten.shape)


# ------------------------------------------------------------- writing

class _Child:
    """A deferred object: ``write(fb)`` places it and returns its
    position."""

    def __init__(self, write):
        self.write = write


class _FlatWriter:
    def __init__(self):
        self.buf = bytearray(8)          # root offset, file identifier

    def pad_to(self, align: int, extra: int = 0) -> None:
        self.buf.extend(b"\0" * ((-(len(self.buf) + extra)) % align))

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def table(self, fields: list) -> int:
        """``fields``: (slot, struct format or None for a child, value)."""
        fields = [f for f in fields if f[2] is not None]
        layout, off, align = [], 4, 4
        for slot, fmt, value in sorted(
                fields, key=lambda f: -struct.calcsize(f[1] or "I")):
            size = struct.calcsize(fmt or "I")
            off += -off % size
            layout.append((slot, fmt, value, off))
            off += size
            align = max(align, size)
        n_slots = 1 + max((f[0] for f in fields), default=-1)
        vtable = struct.pack(f"<{2 + n_slots}H", 4 + 2 * n_slots, off,
                             *[next((o for s, _, _, o in layout if s == i),
                                    0) for i in range(n_slots)])
        self.pad_to(2)
        vt_pos = len(self.buf)
        self.buf += vtable
        self.pad_to(align)
        pos = len(self.buf)
        self.buf += b"\0" * off
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        children = []
        for slot, fmt, value, o in layout:
            if fmt is None:
                children.append((pos + o, value))
            else:
                struct.pack_into("<" + fmt, self.buf, pos + o, value)
        for at, child in children:
            self._patch(at, child.write(self))
        return pos

    def vector(self, fmt: str, values, align: int = 4) -> int:
        size = struct.calcsize(fmt)
        self.pad_to(max(align, size, 4), extra=4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(values))
        if values is not None and len(values):
            self.buf += struct.pack(f"<{len(values)}{fmt}", *values)
        return pos

    def blob(self, data: bytes, align: int = 16) -> int:
        self.pad_to(align, extra=4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(data))
        self.buf += data
        return pos

    def children(self, items: list[_Child]) -> int:
        self.pad_to(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(items))
        slots = len(self.buf)
        self.buf += b"\0" * (4 * len(items))
        for i, item in enumerate(items):
            self._patch(slots + 4 * i, item.write(self))
        return pos

    def string(self, s: str) -> int:
        self.pad_to(4)
        pos = len(self.buf)
        b = s.encode()
        self.buf += struct.pack("<I", len(b)) + b + b"\0"
        return pos


def _vec(fmt, values, align=4):
    return _Child(lambda fb: fb.vector(fmt, list(values), align))


def _str(s):
    return _Child(lambda fb: fb.string(s))


def _tables(items):
    return _Child(lambda fb: fb.children(items))


def _table(fields):
    return _Child(lambda fb: fb.table(fields))


def _options(name: str, values: dict):
    _, spec = OPTIONS[name]
    fields = []
    for fname, slot, fmt in spec:
        v = values.get(fname)
        if v is None:
            continue
        if fmt.startswith("["):
            fields.append((slot, None, _vec(fmt[1:], v)))
        else:
            fields.append((slot, fmt, v))
    return _table(fields)


def encode(m: Model) -> bytes:
    fb = _FlatWriter()

    def opcode(code):
        return _table([(0, "b", min(code, PLACEHOLDER_FOR_GREATER_OP_CODES)),
                       (2, "i", 1), (3, "i", code)])

    def tensor(t: Tensor):
        return _table([(0, None, _vec("i", t.shape)), (1, "b", t.type),
                       (2, "I", t.buffer), (3, None, _str(t.name))])

    def operator(op: Operator):
        fields = [(0, "I", op.opcode), (1, None, _vec("i", op.inputs)),
                  (2, None, _vec("i", op.outputs))]
        if op.options_name:
            fields += [(3, "B", OPTIONS[op.options_name][0]),
                       (4, None, _options(op.options_name, op.options))]
        return _table(fields)

    def buffer(data: bytes):
        if not data:
            return _table([])
        return _table([(0, None, _Child(lambda fb: fb.blob(data)))])

    def tensor_map(name, idx):
        return _table([(0, None, _str(name)), (1, "I", idx)])

    subgraph = _table([
        (0, None, _tables([tensor(t) for t in m.tensors])),
        (1, None, _vec("i", m.inputs)), (2, None, _vec("i", m.outputs)),
        (3, None, _tables([operator(o) for o in m.operators])),
        (4, None, _str("main"))])
    signature = _table([
        (0, None, _tables([tensor_map(k, v) for k, v in
                           m.sig_inputs.items()])),
        (1, None, _tables([tensor_map(k, v) for k, v in
                           m.sig_outputs.items()])),
        (2, None, _str(m.signature_key)), (4, "I", 0)])
    root = fb.table([
        (0, "I", m.version), (1, None, _tables([opcode(c)
                                                for c in m.opcodes])),
        (2, None, _tables([subgraph])), (3, None, _str(m.description)),
        (4, None, _tables([buffer(b) for b in m.buffers])),
        (7, None, _tables([signature]))])
    struct.pack_into("<I", fb.buf, 0, root)
    fb.buf[4:8] = IDENTIFIER
    if len(fb.buf) >= 2 ** 31:
        raise ValueError(f"TFLite file of {len(fb.buf) / 1e9:.2f} GB: over "
                         "the flatbuffer's 2 GB limit")
    return bytes(fb.buf)


# ------------------------------------------------------------- reading

class _View:
    """A table of a flatbuffer: its fields by slot."""

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, slot: int) -> int:
        o = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] \
            if o < self.vt_len else 0

    def scalar(self, slot: int, fmt: str, default=0):
        o = self._off(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] \
            if o else default

    def _ref(self, slot: int) -> int | None:
        o = self._off(slot)
        if not o:
            return None
        at = self.pos + o
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def vector(self, slot: int, fmt: str) -> list:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        return list(struct.unpack_from(f"<{n}{fmt}", self.buf, at + 4))

    def blob(self, slot: int) -> bytes:
        at = self._ref(slot)
        if at is None:
            return b""
        n = struct.unpack_from("<I", self.buf, at)[0]
        return self.buf[at + 4:at + 4 + n]

    def string(self, slot: int) -> str:
        return bytes(self.blob(slot)).decode()

    def table(self, slot: int) -> "_View | None":
        at = self._ref(slot)
        return None if at is None else _View(self.buf, at)

    def tables(self, slot: int) -> list["_View"]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for i in range(n):
            p = at + 4 + 4 * i
            out.append(_View(self.buf, p + struct.unpack_from(
                "<I", self.buf, p)[0]))
        return out


def decode(buf) -> Model:
    """The first subgraph and first signature of a .tflite file."""
    buf = memoryview(buf)
    if bytes(buf[4:8]) != IDENTIFIER:
        raise ValueError("not a TFLite flatbuffer (no TFL3 identifier)")
    root = _View(buf, struct.unpack_from("<I", buf, 0)[0])
    opcodes = [max(o.scalar(3, "i"), o.scalar(0, "b"))
               for o in root.tables(1)]
    sg = root.tables(2)[0]
    tensors = [Tensor(tuple(t.vector(0, "i")), t.scalar(1, "b"),
                      t.scalar(2, "I"), t.string(3)) for t in sg.tables(0)]
    ops = []
    for o in sg.tables(3):
        op = Operator(o.scalar(0, "I"), o.vector(1, "i"), o.vector(2, "i"))
        kind = o.scalar(3, "B")
        if kind:
            op.options_name, spec = _OPTIONS_BY_TYPE[kind]
            opt = o.table(4)
            for fname, slot, fmt in spec:
                op.options[fname] = opt.vector(slot, fmt[1:]) \
                    if fmt.startswith("[") else opt.scalar(slot, fmt)
        ops.append(op)
    buffers = [bytes(b.blob(0)) for b in root.tables(4)]
    sigs = root.tables(7)
    sig_in, sig_out, key = {}, {}, ""
    if sigs:
        key = sigs[0].string(2)
        sig_in = {t.string(0): t.scalar(1, "I") for t in sigs[0].tables(0)}
        sig_out = {t.string(0): t.scalar(1, "I") for t in sigs[0].tables(1)}
    return Model(opcodes, tensors, sg.vector(1, "i"), sg.vector(2, "i"), ops,
                 buffers, sig_in, sig_out, key, root.string(3),
                 root.scalar(0, "I"))


def load(path: str) -> Model:
    with open(path, "rb") as fh:
        return decode(fh.read())


# ----------------------------------------------------------- converting

class _Conv:
    """The TFLite model under construction: tensors by the SavedModel's
    node outputs, buffers, opcodes."""

    def __init__(self):
        self.tensors: list[Tensor] = []
        self.buffers: list[bytes] = [b""]
        self.opcodes: list[int] = []
        self.ops: list[Operator] = []

    def tensor(self, shape, name, data: np.ndarray | None = None,
               ttype: int = FLOAT32) -> int:
        buf = 0
        if data is not None:
            data = np.asarray(data, _NP_OF[ttype], order="C")
            shape = data.shape
            self.buffers.append(data.tobytes())
            buf = len(self.buffers) - 1
        self.tensors.append(Tensor(tuple(int(d) for d in shape), ttype, buf,
                                   name))
        return len(self.tensors) - 1

    def op(self, code: int, inputs, outputs, options_name="", **options):
        if code not in self.opcodes:
            self.opcodes.append(code)
        self.ops.append(Operator(self.opcodes.index(code), list(inputs),
                                 list(outputs), options_name, options))


def _ref_node(ref: str) -> str:
    return ref.lstrip("^").split(":")[0]


def convert(sm) -> Model:
    """A ``tf_proto.SavedModelFile`` (written by ``tf_proto``) as a TFLite
    ``Model``: the ``serving_default`` signature's body, one builtin per
    node or fused group."""
    from mmidet_tpu_torch.deploy.tf_proto import DT_FLOAT
    from mmidet_tpu_torch.deploy.tf_proto import SIGNATURE_KEY as KEY
    wrapper = sm.signature_function(KEY)
    call = next(n for n in wrapper.nodes if n.op.endswith("PartitionedCall"))
    body = sm.functions[call.attrs["f"]]
    sig = sm.signatures[KEY]
    # the signature's output keys by the wrapper's output index
    out_keys = {int(tname.split(":")[1]): key
                for key, (tname, _, _) in sig.outputs.items()}
    nodes = {n.name: n for n in body.nodes}
    consumers: dict[str, list] = {}
    for n in body.nodes:
        for i in n.inputs:
            consumers.setdefault(_ref_node(i), []).append(n)
    const = {n.name: n.attrs["value"] for n in body.nodes if n.op == "Const"}

    def const_of(ref):
        return const.get(_ref_node(ref))

    def is_const(ref, v: float) -> bool:
        c = const_of(ref)
        return c is not None and c.size == 1 and np.isclose(float(c), v)

    def only_consumer(name):
        c = consumers.get(name, [])
        return c[0] if len(c) == 1 else None

    # fused groups: a bias add into its conv or constant-weight matmul
    # (``out_of``: the node whose output the fused op writes); the GELU
    # chain x * (erf(x * 2^-0.5) + 1) * 0.5 into one GELU
    bias_of, out_of, fused_away, gelu_of = {}, {}, set(), {}
    for n in body.nodes:
        if n.op in ("Conv2D", "DepthwiseConv2dNative", "BatchMatMulV2"):
            nxt = only_consumer(n.name)
            rhs = const_of(n.inputs[1])
            if n.op == "BatchMatMulV2" and (rhs is None or rhs.ndim != 2):
                continue
            if (nxt is not None and nxt.op == "BiasAdd"
                    and _ref_node(nxt.inputs[0]) == n.name
                    and const_of(nxt.inputs[1]) is not None):
                bias_of[n.name] = const_of(nxt.inputs[1])
                out_of[n.name] = nxt.name
                fused_away.add(nxt.name)
        elif n.op == "Erf":
            scaled = nodes[_ref_node(n.inputs[0])]
            plus1 = only_consumer(n.name)
            xe = plus1 and only_consumer(plus1.name)
            last = xe and only_consumer(xe.name)
            x = scaled.inputs[0]
            if not (scaled.op == "Mul" and only_consumer(scaled.name) is n
                    and is_const(scaled.inputs[1], 2 ** -0.5)
                    and plus1 is not None and plus1.op == "AddV2"
                    and is_const(plus1.inputs[1], 1.0)
                    and xe is not None and xe.op == "Mul"
                    and xe.inputs[0] == x and last is not None
                    and last.op == "Mul" and is_const(last.inputs[1], 0.5)):
                raise ValueError("TFLite export: an Erf outside the exact "
                                 f"GELU has no builtin (node {n.name!r})")
            fused_away.update({scaled.name, n.name, plus1.name, xe.name})
            gelu_of[last.name] = x

    cv = _Conv()
    env: dict[str, int] = {}          # node name -> tensor

    def shape_of(n):
        return n.attrs["_output_shapes"][0]

    # the body's args, named as TF's converter names them
    for name, dt in body.args:
        if dt != DT_FLOAT:
            raise ValueError(f"TFLite export: input {name!r} is not f32 "
                             "(bfloat16 inputs have no TFLite builtin form; "
                             "export the SavedModel in f32)")
        env[name] = cv.tensor(sig.inputs[name][2],
                              f"serving_default_{name}:0")

    def t_in(ref):
        name = _ref_node(ref)
        if name in env:
            return env[name]
        arr = const_of(ref)
        if arr is None:
            raise ValueError(f"TFLite export: {ref!r} is not computed yet")
        env[name] = cv.tensor(arr.shape, name, arr.astype(np.float32)
                              if arr.dtype != np.int32 else arr,
                              FLOAT32 if arr.dtype != np.int32 else INT32)
        return env[name]

    def ints(name, vals):
        return cv.tensor(None, name, np.asarray(vals, np.int32), INT32)

    def pad_of(n):
        return SAME if n.attrs["padding"] == b"SAME" else VALID

    for n in body.nodes:
        if n.op in ("Const", "NoOp") or n.name in fused_away:
            continue
        if n.op == "Identity":
            env[n.name] = t_in(n.inputs[0])
            continue
        name = out_of.get(n.name, n.name)
        out_node = nodes[name]
        out = cv.tensor(shape_of(out_node), name)
        ins = n.inputs
        if n.name in gelu_of:
            cv.op(GELU, [t_in(gelu_of[n.name])], [out], "GeluOptions",
                  approximate=False)
        elif n.op in ("Conv2D", "DepthwiseConv2dNative"):
            w = const_of(ins[1])
            s = n.attrs["strides"]
            b = bias_of.get(n.name)
            if n.op == "Conv2D":
                wt = cv.tensor(None, f"{n.name}/filter",
                               w.transpose(3, 0, 1, 2))
                co = w.shape[3]
            else:
                kh, kw, c, m = w.shape
                wt = cv.tensor(None, f"{n.name}/filter",
                               w.reshape(1, kh, kw, c * m))
                co = c * m
            bt = cv.tensor(None, f"{n.name}/bias", np.zeros(co, np.float32)
                           if b is None else b)
            common = dict(padding=pad_of(n), stride_w=s[2], stride_h=s[1],
                          fused_activation=0, dilation_w=1, dilation_h=1)
            if n.op == "Conv2D":
                cv.op(CONV_2D, [t_in(ins[0]), wt, bt], [out],
                      "Conv2DOptions", **common)
            else:
                cv.op(DEPTHWISE_CONV_2D, [t_in(ins[0]), wt, bt], [out],
                      "DepthwiseConv2DOptions", depth_multiplier=m,
                      **common)
        elif n.op == "BatchMatMulV2":
            rhs = const_of(ins[1])
            if rhs is not None and rhs.ndim == 2 and not n.attrs.get(
                    "adj_y"):
                wt = cv.tensor(None, f"{n.name}/weights",
                               np.ascontiguousarray(rhs.T))
                b = bias_of.get(n.name)
                bt = -1 if b is None else cv.tensor(None, f"{n.name}/bias", b)
                cv.op(FULLY_CONNECTED, [t_in(ins[0]), wt, bt], [out],
                      "FullyConnectedOptions", fused_activation=0,
                      weights_format=0, keep_num_dims=True)
            else:
                cv.op(BATCH_MATMUL, [t_in(ins[0]), t_in(ins[1])], [out],
                      "BatchMatMulOptions",
                      adj_x=bool(n.attrs.get("adj_x")),
                      adj_y=bool(n.attrs.get("adj_y")))
        elif n.op in _BINARY:
            code, opt = _BINARY[n.op]
            cv.op(code, [t_in(ins[0]), t_in(ins[1])], [out], opt,
                  **({"fused_activation": 0} if opt else {}))
        elif n.op in _UNARY:
            cv.op(_UNARY[n.op], [t_in(ins[0])], [out])
        elif n.op == "LeakyRelu":
            cv.op(LEAKY_RELU, [t_in(ins[0])], [out], "LeakyReluOptions",
                  alpha=float(n.attrs["alpha"]))
        elif n.op == "Softmax":
            cv.op(SOFTMAX, [t_in(ins[0])], [out], "SoftmaxOptions", beta=1.0)
        elif n.op == "ConcatV2":
            axis = int(const_of(ins[-1]))
            cv.op(CONCATENATION, [t_in(i) for i in ins[:-1]], [out],
                  "ConcatenationOptions", axis=axis, fused_activation=0)
        elif n.op == "MaxPool":
            k, s = n.attrs["ksize"], n.attrs["strides"]
            cv.op(MAX_POOL_2D, [t_in(ins[0])], [out], "Pool2DOptions",
                  padding=pad_of(n), stride_w=s[2], stride_h=s[1],
                  filter_width=k[2], filter_height=k[1], fused_activation=0)
        elif n.op == "ResizeNearestNeighbor":
            cv.op(RESIZE_NEAREST_NEIGHBOR, [t_in(ins[0]), ints(
                f"{n.name}/size", const_of(ins[1]))], [out],
                "ResizeNearestNeighborOptions",
                align_corners=bool(n.attrs.get("align_corners")),
                half_pixel_centers=bool(n.attrs.get("half_pixel_centers")))
        elif n.op == "Pad":
            cv.op(PAD, [t_in(ins[0]), ints(f"{n.name}/paddings",
                                           const_of(ins[1]))], [out],
                  "PadOptions")
        elif n.op == "PadV2":
            cv.op(PADV2, [t_in(ins[0]), ints(f"{n.name}/paddings",
                                             const_of(ins[1])),
                          t_in(ins[2])], [out], "PadV2Options")
        elif n.op == "ReverseV2":
            cv.op(REVERSE_V2, [t_in(ins[0]), ints(f"{n.name}/axis",
                                                  const_of(ins[1]))], [out],
                  "ReverseV2Options")
        elif n.op in ("SpaceToDepth", "DepthToSpace"):
            code, opt = (SPACE_TO_DEPTH, "SpaceToDepthOptions") \
                if n.op == "SpaceToDepth" else (DEPTH_TO_SPACE,
                                                "DepthToSpaceOptions")
            cv.op(code, [t_in(ins[0])], [out], opt,
                  block_size=int(n.attrs["block_size"]))
        elif n.op == "Reshape":
            shape = [int(v) for v in const_of(ins[1])]
            cv.op(RESHAPE, [t_in(ins[0]), ints(f"{n.name}/shape", shape)],
                  [out], "ReshapeOptions", new_shape=shape)
        elif n.op == "Transpose":
            cv.op(TRANSPOSE, [t_in(ins[0]), ints(f"{n.name}/perm",
                                                 const_of(ins[1]))], [out],
                  "TransposeOptions")
        elif n.op == "Mean":
            cv.op(MEAN, [t_in(ins[0]), ints(f"{n.name}/axes",
                                            np.ravel(const_of(ins[1])))],
                  [out], "ReducerOptions",
                  keep_dims=bool(n.attrs.get("keep_dims")))
        elif n.op == "StridedSlice":
            if any(n.attrs.get(m, 0) for m in (
                    "ellipsis_mask", "new_axis_mask", "shrink_axis_mask")):
                raise ValueError(f"TFLite export: StridedSlice {n.name!r} "
                                 "with axis masks")
            cv.op(STRIDED_SLICE, [t_in(ins[0])] + [
                ints(f"{n.name}/{k}", const_of(r)) for k, r in zip(
                    ("begin", "end", "strides"), ins[1:4])], [out],
                "StridedSliceOptions",
                begin_mask=n.attrs.get("begin_mask", 0),
                end_mask=n.attrs.get("end_mask", 0), ellipsis_mask=0,
                new_axis_mask=0, shrink_axis_mask=0)
        else:
            raise ValueError(f"TFLite export: no builtin for op {n.op!r} "
                             f"(node {n.name!r})")
        env[name] = out
    # outputs: the wrapper's output j is the body's output through the
    # call; TF's converter names them after the signature's call
    outputs, sig_out = [], {}
    for j, (oname, _) in enumerate(wrapper.outputs):
        src = wrapper.ret[oname]              # Identity_j:output:0
        idn = next(x for x in wrapper.nodes if x.name == _ref_node(src))
        k = int(idn.inputs[0].split(":")[-1])
        body_ref = body.ret[body.outputs[k][0]]
        t = env[_ref_node(body_ref)]
        cv.tensors[t].name = f"PartitionedCall:{j}"
        outputs.append(t)
        sig_out[out_keys[j]] = t
    inputs = [env[name] for name, _ in body.args]
    return Model(cv.opcodes, cv.tensors, inputs, outputs, cv.ops,
                 cv.buffers, {name: env[name] for name, _ in body.args},
                 sig_out)


_BINARY = {"AddV2": (ADD, "AddOptions"), "BiasAdd": (ADD, "AddOptions"),
           "Sub": (SUB, "SubOptions"), "Mul": (MUL, "MulOptions"),
           "RealDiv": (DIV, "DivOptions"),
           "SquaredDifference": (SQUARED_DIFFERENCE,
                                 "SquaredDifferenceOptions")}
_UNARY = {"Sigmoid": LOGISTIC, "Relu": RELU, "Relu6": RELU6,
          "Rsqrt": RSQRT, "Exp": EXP, "Log": LOG}
