"""Minimal numpy runner for the port's SavedModel and TFLite files.

Counterpart of ``onnx_np`` for the TF legs: it executes the *decoded*
files (``tf_proto.load``, ``tflite_fb.load``), so that a test or
``chip_smoke.py`` holds the full write -> bytes -> decode -> execute path
against the port's forward where TensorFlow is absent (the card's
machine).  A SavedModel runs through its ``serving_default`` signature
(the wrapper function, its call into the body, the body's nodes), with
TF's op semantics; a TFLite file through its signature's subgraph, with
the builtins' semantics (OHWI filters, (out, in) fully-connected weights,
SAME/VALID padding).  Only the ops the port writes are known; any other
raises ``NotImplementedError``.  A conformance oracle for tests, not a
production runtime: convolutions are im2col products (``np.matmul``).
"""

from __future__ import annotations

import math

import numpy as np

from mmidet_tpu_torch.deploy import tflite_fb as fb
from mmidet_tpu_torch.deploy.tf_proto import SIGNATURE_KEY, SavedModelFile


# ------------------------------------------------------------- numerics

def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x, kh, kw, sh, sw, same: bool, value=0.0):
    if not same:
        return x
    (t, b), (le, r) = _same_pads(x.shape[1], kh, sh), \
        _same_pads(x.shape[2], kw, sw)
    return np.pad(x, ((0, 0), (t, b), (le, r), (0, 0)),
                  constant_values=value)


def conv2d(x, w_hwio, sh: int, sw: int, same: bool):
    """NHWC conv by im2col: patches in (kh, kw, cin) order against the
    (kh*kw*cin, cout) filter; a filter of fewer input channels than ``x``
    has is grouped (each group's outputs read its own channels)."""
    kh, kw, ci, co = w_hwio.shape
    groups = x.shape[3] // ci
    if groups > 1:
        cg = co // groups
        return np.concatenate([conv2d(
            x[..., i * ci:(i + 1) * ci], w_hwio[..., i * cg:(i + 1) * cg],
            sh, sw, same) for i in range(groups)], -1)
    x = _pad_nhwc(x, kh, kw, sh, sw, same)
    b, h, w, _ = x.shape
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    if kh == kw == sh == sw == 1:
        cols = x
    else:
        cols = np.concatenate([x[:, i:i + sh * ho:sh, j:j + sw * wo:sw]
                               for i in range(kh) for j in range(kw)], -1)
    return np.matmul(cols.reshape(-1, kh * kw * ci),
                     w_hwio.reshape(-1, co)).reshape(b, ho, wo, co)


def depthwise_conv2d(x, w, sh: int, sw: int, same: bool):
    """w: (kh, kw, C, m); output channel c*m + j."""
    kh, kw, c, m = w.shape
    x = _pad_nhwc(x, kh, kw, sh, sw, same)
    b, h, wd, _ = x.shape
    ho, wo = (h - kh) // sh + 1, (wd - kw) // sw + 1
    out = np.zeros((b, ho, wo, c, m), np.float32)
    for i in range(kh):
        for j in range(kw):
            out += x[:, i:i + sh * ho:sh, j:j + sw * wo:sw, :, None] \
                * w[i, j]
    return out.reshape(b, ho, wo, c * m)


def max_pool(x, kh, kw, sh: int, sw: int, same: bool):
    x = _pad_nhwc(x, kh, kw, sh, sw, same, -np.inf)
    b, h, w, c = x.shape
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    out = np.full((b, ho, wo, c), -np.inf, np.float32)
    for i in range(kh):
        for j in range(kw):
            out = np.maximum(out, x[:, i:i + sh * ho:sh, j:j + sw * wo:sw])
    return out


def space_to_depth(x, s: int):
    """TF's order: output channel (sh * s + sw) * C + c."""
    b, h, w, c = x.shape
    return x.reshape(b, h // s, s, w // s, s, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)


def depth_to_space(x, s: int):
    b, h, w, c = x.shape
    return x.reshape(b, h, w, s, s, c // (s * s)).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, c // (s * s))


def resize_nearest(x, size):
    """Nearest resize without corner alignment or half-pixel centres:
    source index floor(i * in / out)."""
    def index(n_in, n_out):
        return np.arange(n_out) * n_in // n_out
    return x[:, index(x.shape[1], int(size[0]))][
        :, :, index(x.shape[2], int(size[1]))]


def strided_slice(x, begin, end, strides):
    return x[tuple(slice(int(b), int(e), int(s))
                   for b, e, s in zip(begin, end, strides))]


def softmax(x, beta=1.0):
    z = beta * x
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


_erf = np.vectorize(math.erf, otypes=[np.float64])


def gelu(x):
    return 0.5 * x * (1.0 + _erf(x / math.sqrt(2.0)))


def _f32(a):
    return a.astype(np.float32) if a.dtype == np.float64 else a


# ------------------------------------------------------------ SavedModel

_MASKS = ("begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
          "shrink_axis_mask")
_TF_BINARY = {"AddV2": np.add, "BiasAdd": np.add, "Sub": np.subtract,
              "Mul": np.multiply, "RealDiv": np.divide,
              "SquaredDifference": lambda a, b: (a - b) ** 2}
_TF_UNARY = {"Sigmoid": sigmoid, "Relu": lambda x: np.maximum(x, 0),
             "Relu6": lambda x: np.clip(x, 0, 6), "Erf": _erf,
             "Rsqrt": lambda x: 1.0 / np.sqrt(x), "Softmax": softmax,
             "Identity": lambda x: x, "Exp": np.exp, "Log": np.log}


def _tf_node(sm, n, i):
    a, op = n.attrs, n.op
    if op in _TF_BINARY:
        return [_TF_BINARY[op](i[0], i[1])]
    if op in _TF_UNARY:
        return [_TF_UNARY[op](i[0])]
    if op == "Const":
        return [a["value"]]
    if op == "LeakyRelu":
        return [np.where(i[0] >= 0, i[0], a["alpha"] * i[0])]
    if op in ("Conv2D", "DepthwiseConv2dNative"):
        fn = conv2d if op == "Conv2D" else depthwise_conv2d
        return [fn(i[0], i[1], a["strides"][1], a["strides"][2],
                   a["padding"] == b"SAME")]
    if op == "MaxPool":
        k, s = a["ksize"], a["strides"]
        return [max_pool(i[0], k[1], k[2], s[1], s[2],
                         a["padding"] == b"SAME")]
    if op == "ConcatV2":
        return [np.concatenate(i[:-1], axis=int(i[-1]))]
    if op == "ResizeNearestNeighbor":
        if a.get("align_corners") or a.get("half_pixel_centers"):
            raise NotImplementedError("ResizeNearestNeighbor's options")
        return [resize_nearest(i[0], i[1])]
    if op == "Pad":
        return [np.pad(i[0], [tuple(p) for p in i[1]])]
    if op == "PadV2":
        return [np.pad(i[0], [tuple(p) for p in i[1]],
                       constant_values=i[2])]
    if op == "ReverseV2":
        return [np.flip(i[0], tuple(int(v) for v in i[1]))]
    if op == "SpaceToDepth":
        return [space_to_depth(i[0], a["block_size"])]
    if op == "DepthToSpace":
        return [depth_to_space(i[0], a["block_size"])]
    if op == "Reshape":
        return [i[0].reshape([int(v) for v in i[1]])]
    if op == "Transpose":
        return [np.transpose(i[0], [int(v) for v in i[1]])]
    if op == "BatchMatMulV2":
        x, y = i[0], i[1]
        if a.get("adj_x"):
            x = np.swapaxes(x, -1, -2)
        if a.get("adj_y"):
            y = np.swapaxes(y, -1, -2)
        return [np.matmul(x, y)]
    if op == "Mean":
        return [i[0].mean(axis=tuple(int(v) for v in np.ravel(i[1])),
                          keepdims=bool(a.get("keep_dims")))]
    if op == "StridedSlice":
        if any(a.get(m, 0) for m in _MASKS):
            raise NotImplementedError("StridedSlice masks")
        return [strided_slice(i[0], i[1], i[2], i[3])]
    if op == "Cast":
        return [i[0].astype(np.float32)]
    if op in ("PartitionedCall", "StatefulPartitionedCall"):
        return run_function(sm, sm.functions[a["f"]], i)
    raise NotImplementedError(f"op {op}")


def run_function(sm: SavedModelFile, fn, args: list) -> list:
    """The outputs of function ``fn`` of ``sm`` on ``args`` (its input
    arguments in order)."""
    env = {name: np.asarray(v) for (name, _), v in zip(fn.args, args)}

    def get(ref: str):
        parts = ref.split(":")
        if len(parts) == 1:
            return env[parts[0]]
        return env[parts[0]][int(parts[2])]
    for n in fn.nodes:
        if n.op == "NoOp":
            continue
        outs = _tf_node(sm, n, [get(r) for r in n.inputs
                                if not r.startswith("^")])
        env[n.name] = [_f32(np.asarray(o)) for o in outs]
    return [get(fn.ret[name]) for name, _ in fn.outputs]


def run_savedmodel(sm: SavedModelFile, feeds: dict[str, np.ndarray],
                   key: str = SIGNATURE_KEY) -> dict[str, np.ndarray]:
    """The signature ``key`` of ``sm`` on ``feeds`` (by input name): its
    outputs by key."""
    fn = sm.signature_function(key)
    outs = run_function(sm, fn, [np.asarray(feeds[name], np.float32)
                                 for name, _ in fn.args])
    sig = sm.signatures[key]
    return {k: outs[int(t.split(":")[1])] for k, (t, _, _) in
            sig.outputs.items()}


# ---------------------------------------------------------------- TFLite

_FB_BINARY = {fb.ADD: np.add, fb.SUB: np.subtract, fb.MUL: np.multiply,
              fb.DIV: np.divide,
              fb.SQUARED_DIFFERENCE: lambda a, b: (a - b) ** 2}
_FB_UNARY = {fb.LOGISTIC: sigmoid, fb.RELU: lambda x: np.maximum(x, 0),
             fb.RELU6: lambda x: np.clip(x, 0, 6), fb.GELU: gelu,
             fb.RSQRT: lambda x: 1.0 / np.sqrt(x), fb.EXP: np.exp,
             fb.LOG: np.log}


def _fb_op(code, o, i):
    if code in _FB_BINARY:
        return _FB_BINARY[code](i[0], i[1])
    if code in _FB_UNARY:
        return _FB_UNARY[code](i[0])
    same = o.get("padding") == fb.SAME
    if code == fb.CONV_2D:
        y = conv2d(i[0], i[1].transpose(1, 2, 3, 0), o["stride_h"],
                   o["stride_w"], same)
        return y + i[2] if i[2] is not None else y
    if code == fb.DEPTHWISE_CONV_2D:
        _, kh, kw, cm = i[1].shape
        m = o["depth_multiplier"]
        y = depthwise_conv2d(i[0], i[1].reshape(kh, kw, cm // m, m),
                             o["stride_h"], o["stride_w"], same)
        return y + i[2] if i[2] is not None else y
    if code == fb.FULLY_CONNECTED:
        if not o.get("keep_num_dims"):
            raise NotImplementedError("FULLY_CONNECTED without keep_num_dims")
        y = np.matmul(i[0], i[1].T)
        return y + i[2] if len(i) > 2 and i[2] is not None else y
    if code == fb.LEAKY_RELU:
        return np.where(i[0] >= 0, i[0], o["alpha"] * i[0])
    if code == fb.SOFTMAX:
        return softmax(i[0], o.get("beta", 1.0))
    if code == fb.CONCATENATION:
        return np.concatenate(i, axis=o["axis"])
    if code == fb.MAX_POOL_2D:
        return max_pool(i[0], o["filter_height"], o["filter_width"],
                        o["stride_h"], o["stride_w"], same)
    if code == fb.RESIZE_NEAREST_NEIGHBOR:
        if o.get("align_corners") or o.get("half_pixel_centers"):
            raise NotImplementedError("RESIZE_NEAREST_NEIGHBOR's options")
        return resize_nearest(i[0], i[1])
    if code == fb.PAD:
        return np.pad(i[0], [tuple(p) for p in i[1]])
    if code == fb.PADV2:
        return np.pad(i[0], [tuple(p) for p in i[1]], constant_values=i[2])
    if code == fb.REVERSE_V2:
        return np.flip(i[0], tuple(int(v) for v in i[1]))
    if code == fb.SPACE_TO_DEPTH:
        return space_to_depth(i[0], o["block_size"])
    if code == fb.DEPTH_TO_SPACE:
        return depth_to_space(i[0], o["block_size"])
    if code == fb.RESHAPE:
        return i[0].reshape([int(v) for v in i[1]])
    if code == fb.TRANSPOSE:
        return np.transpose(i[0], [int(v) for v in i[1]])
    if code == fb.MEAN:
        return i[0].mean(axis=tuple(int(v) for v in i[1]),
                         keepdims=bool(o.get("keep_dims")))
    if code == fb.STRIDED_SLICE:
        if any(o.get(m, 0) for m in _MASKS):
            raise NotImplementedError("STRIDED_SLICE masks")
        return strided_slice(i[0], i[1], i[2], i[3])
    if code == fb.BATCH_MATMUL:
        x, y = i[0], i[1]
        if o.get("adj_x"):
            x = np.swapaxes(x, -1, -2)
        if o.get("adj_y"):
            y = np.swapaxes(y, -1, -2)
        return np.matmul(x, y)
    raise NotImplementedError(f"builtin {fb.BUILTIN_NAMES.get(code, code)}")


def run_tflite(m: fb.Model, feeds: dict[str, np.ndarray]
               ) -> dict[str, np.ndarray]:
    """The signature of ``m`` on ``feeds`` (by input name): its outputs by
    name."""
    env: dict[int, np.ndarray] = {}
    for name, t in m.sig_inputs.items():
        env[t] = np.asarray(feeds[name], np.float32)

    def get(t: int):
        if t < 0:
            return None
        if t not in env:
            env[t] = m.array(t)
        return env[t]
    for op in m.operators:
        y = _fb_op(m.opcodes[op.opcode], op.options,
                   [get(t) for t in op.inputs])
        env[op.outputs[0]] = _f32(np.asarray(y))
    return {k: env[t] for k, t in m.sig_outputs.items()}


def run(model, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A decoded SavedModel (``tf_proto.load``) or TFLite file
    (``tflite_fb.load``) on ``feeds``: its signature's outputs by key."""
    if isinstance(model, fb.Model):
        return run_tflite(model, feeds)
    return run_savedmodel(model, feeds)
