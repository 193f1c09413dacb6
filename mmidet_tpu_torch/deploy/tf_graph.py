"""NHWC graph of the deploy forward, for the SavedModel and TFLite legs.

Counterpart of what ``jax2tf`` lowers in ``mmidet_tpu/deploy/export.py``
(``export_savedmodel(native=False)``).  Like ``onnx_export``, the graph is
*emitted structurally*: ``emit_graph`` walks ``resolve(spec)`` with the
row walk and row emitters it shares with the ONNX emitter
(``deploy/rows.py``) over a BN-folded copy of the detector, and reads
each module's weights as f32 on the CPU.  The tensors are NHWC from the inputs on (TF's CPU ``Conv2D`` and
``MaxPool`` take no NCHW, and TFLite has no NCHW at all), and the weights
are laid out as TF takes them: conv filters HWIO, depthwise filters
(H, W, C, 1), matmul right-hand sides (in, out).

The result, a ``TFGraph``, is a list of primitive ops that both file
writers and the numpy runner understand, with every value's static shape:

  conv2d, depthwise_conv2d (x, filter[, bias]; ``stride``, ``pads``
  (top, bottom, left, right)), add, sub, mul, div, squared_difference,
  sigmoid, relu, leaky_relu (``alpha``), hardswish, gelu (exact, erf),
  concat (``axis``), max_pool (``k``, stride 1, SAME), resize_nearest
  (``scale``; no corner alignment, no half-pixel centres), pad
  (``pads`` per dim), reshape (``shape``), transpose (``perm``), matmul
  (a, b[, bias]; batched, broadcast), softmax (last axis), mean (``axes``,
  keepdims), rsqrt, strided_slice (``begin``, ``end``, ``strides``) and
  cast (``to``).

As in the ONNX graph the kernels play no part: the CEM, the fusion blocks
and their merges are the plain ops they compute, and GPT1_fourier's
inference graph is GPT1's.  The fusion blocks' average pool and bilinear
upsample are the constant matrices of ``nn/resize.py`` (as the JAX
package computes them, ``mmidet_tpu/nn/fusion.py:43``), here as one
matmul each over the flattened map.  A row with no form here (MambaFusion,
a bilinear Upsample, the other YAML rows) raises ``ValueError``, as does
the s8-storage (quantized) model.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from mmidet_tpu_torch.deploy.rows import (detect_grid, emit_cem, np32,
                                          rows, walk)
from mmidet_tpu_torch.models.spec import ModelSpec, is_two_stream
from mmidet_tpu_torch.nn.layers import autopad
from mmidet_tpu_torch.nn.resize import (_adaptive_avg_weights,
                                        _bilinear_weights)

LN_EPS = 1e-5
WHAT = "SavedModel export"

UNARY = ("sigmoid", "relu", "leaky_relu", "hardswish", "gelu", "softmax",
         "rsqrt", "cast")
BINARY = ("add", "sub", "mul", "div", "squared_difference")


@dataclass
class Op:
    kind: str
    inputs: list[str]
    output: str
    attrs: dict = field(default_factory=dict)


@dataclass
class TFGraph:
    """Inputs as (name, shape, dtype), the output value names, the ops in
    order, the constants by name and every value's shape and dtype
    (``"float32"``, or ``"bfloat16"`` for a bf16 input)."""
    inputs: list[tuple[str, tuple, str]]
    outputs: list[str]
    ops: list[Op]
    consts: dict[str, np.ndarray]
    shapes: dict[str, tuple]
    dtypes: dict[str, str]


def _conv_out(n: int, k: int, s: int, lo: int, hi: int) -> int:
    return (n + lo + hi - k) // s + 1


def infer_shape(kind: str, shapes: list[tuple], attrs: dict) -> tuple:
    """The static shape of an op's output from its inputs'."""
    x = shapes[0]
    if kind in ("conv2d", "depthwise_conv2d"):
        kh, kw, ci, co = shapes[1]
        t, b, le, r = attrs["pads"]
        s = attrs["stride"]
        c = x[3] * co if kind == "depthwise_conv2d" else co
        return (x[0], _conv_out(x[1], kh, s, t, b),
                _conv_out(x[2], kw, s, le, r), c)
    if kind in UNARY or kind == "max_pool":
        return tuple(x)
    if kind in BINARY:
        return tuple(np.broadcast_shapes(*shapes))
    if kind == "concat":
        ax = attrs["axis"] % len(x)
        return tuple(sum(s[ax] for s in shapes) if i == ax else d
                     for i, d in enumerate(x))
    if kind == "resize_nearest":
        s = attrs["scale"]
        return (x[0], x[1] * s, x[2] * s, x[3])
    if kind == "pad":
        return tuple(d + lo + hi for d, (lo, hi) in zip(x, attrs["pads"]))
    if kind == "reshape":
        assert math.prod(attrs["shape"]) == math.prod(x), (x, attrs)
        return tuple(attrs["shape"])
    if kind == "transpose":
        return tuple(x[p] for p in attrs["perm"])
    if kind == "matmul":
        a, b = shapes[0], shapes[1]
        assert a[-1] == b[-2], (a, b)
        return tuple(np.broadcast_shapes(a[:-2], b[:-2])) + (a[-2], b[-1])
    if kind == "mean":
        axes = [a % len(x) for a in attrs["axes"]]
        return tuple(1 if i in axes else d for i, d in enumerate(x))
    if kind == "strided_slice":
        return tuple(len(range(b, min(e, d), s)) for d, b, e, s in zip(
            x, attrs["begin"], attrs["end"], attrs["strides"]))
    raise ValueError(f"no shape rule for {kind!r}")


class Emitter:
    what = WHAT

    def __init__(self):
        self.ops: list[Op] = []
        self.consts: dict[str, np.ndarray] = {}
        self.shapes: dict[str, tuple] = {}
        self.dtypes: dict[str, str] = {}
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        arr = np.asarray(arr, np.float32, order="C")
        self.consts[name] = arr
        self.shapes[name] = arr.shape
        self.dtypes[name] = "float32"
        return name

    def op(self, kind: str, inputs: list[str], **attrs) -> str:
        out = self.fresh(kind)
        self.ops.append(Op(kind, list(inputs), out, attrs))
        self.shapes[out] = infer_shape(kind, [self.shapes[i] for i in inputs],
                                       attrs)
        self.dtypes[out] = attrs.get("to", "float32")
        return out

    # ---- composites ---------------------------------------------------
    def conv(self, x: str, kernel_oihw: np.ndarray, bias: np.ndarray | None,
             stride: int = 1, pads=None, groups: int = 1) -> str:
        """An OIHW conv as ``conv2d`` (groups 1) or ``depthwise_conv2d``
        (one group a channel); ``pads`` (top, left, bottom, right) as the
        ONNX emitter takes them."""
        co, cig, kh, kw = kernel_oihw.shape
        if pads is None:
            p = autopad(kh)
            pads = (p, p, p, p)
        pads = (pads[0], pads[2], pads[1], pads[3])        # t, b, l, r
        ins = [x]
        if groups == 1:
            ins.append(self.const("w", kernel_oihw.transpose(2, 3, 1, 0)))
            kind = "conv2d"
        elif groups == co == self.shapes[x][3] and cig == 1:
            ins.append(self.const("w", kernel_oihw[:, 0].transpose(1, 2, 0)
                                  [..., None]))
            kind = "depthwise_conv2d"
        else:
            raise ValueError(f"{WHAT}: grouped conv with {groups} groups of "
                             f"{cig} channels has no TF/TFLite form")
        if bias is not None:
            ins.append(self.const("b", bias))
        return self.op(kind, ins, stride=stride, pads=tuple(pads))

    def act(self, x: str, name: str | None) -> str:
        if name in (None, "identity"):
            return x
        if name == "silu":
            return self.op("mul", [x, self.op("sigmoid", [x])])
        if name == "leaky0.1":
            return self.op("leaky_relu", [x], alpha=0.1)
        if name == "relu":
            return self.op("relu", [x])
        if name == "hardswish":
            return self.op("hardswish", [x])
        raise ValueError(f"{WHAT}: unsupported activation {name!r}")

    def add(self, a: str, b: str) -> str:
        return self.op("add", [a, b])

    def concat(self, xs: list[str]) -> str:
        return self.op("concat", list(xs), axis=3)

    def max_pool(self, x: str, k: int) -> str:
        return self.op("max_pool", [x], k=int(k))

    def upsample(self, x: str, scale: int) -> str:
        return self.op("resize_nearest", [x], scale=scale)

    def dense(self, x: str, w_in_out: np.ndarray,
              bias: np.ndarray | None = None) -> str:
        ins = [x, self.const("dk", w_in_out)]
        if bias is not None:
            ins.append(self.const("db", bias))
        return self.op("matmul", ins)

    def linear(self, x: str, lin: torch.nn.Linear) -> str:
        return self.dense(x, np32(lin.weight).T,
                          None if lin.bias is None else np32(lin.bias))

    def reshape(self, x: str, shape) -> str:
        return self.op("reshape", [x], shape=tuple(int(v) for v in shape))

    def transpose(self, x: str, perm) -> str:
        return self.op("transpose", [x], perm=tuple(int(v) for v in perm))

    def slice_last(self, x: str, lo: int, hi: int) -> str:
        shape = self.shapes[x]
        return self.op("strided_slice", [x],
                       begin=(0,) * (len(shape) - 1) + (lo,),
                       end=tuple(shape[:-1]) + (hi,),
                       strides=(1,) * len(shape))

    def slice_axis(self, x: str, axis: int, lo: int, hi: int) -> str:
        shape = self.shapes[x]
        begin = [0] * len(shape)
        end = list(shape)
        begin[axis], end[axis] = lo, hi
        return self.op("strided_slice", [x], begin=tuple(begin),
                       end=tuple(end), strides=(1,) * len(shape))

    def const_mul(self, x: str, v: float) -> str:
        return self.op("mul", [x, self.const("c", np.float32(v).reshape(()))])

    def const_add(self, x: str, v: float) -> str:
        return self.op("add", [x, self.const("c", np.float32(v).reshape(()))])

    def layernorm(self, x: str, ln: torch.nn.LayerNorm) -> str:
        """Mean, squared difference, rsqrt: (x - mu) * rsqrt(var + eps) *
        scale + bias over the last axis."""
        mu = self.op("mean", [x], axes=(-1,))
        var = self.op("mean", [self.op("squared_difference", [x, mu])],
                      axes=(-1,))
        r = self.op("rsqrt", [self.const_add(var, LN_EPS)])
        y = self.op("mul", [self.op("sub", [x, mu]), r])
        y = self.op("mul", [y, self.const("lns", np32(ln.weight))])
        return self.op("add", [y, self.const("lnb", np32(ln.bias))])


def _resample(g, x, c, n_in, n_out, a: np.ndarray) -> str:
    """(B, n_in, C) -> (B, n_out, C) by the constant (n_out, n_in)
    matrix ``a``: one matmul over the channel-major form."""
    b = g.shapes[x][0]
    y = g.transpose(g.reshape(x, (b, n_in, c)), (0, 2, 1))   # (B, C, n_in)
    y = g.dense(y, a.T)                                      # (B, C, n_out)
    return g.transpose(y, (0, 2, 1))


def _pool_tokens(g, x, h, w, gh, gw) -> str:
    """NHWC (B, H, W, C) -> tokens (B, gh*gw, C) by the adaptive average
    pool's matrices (``nn/resize.py``), as one (gh*gw, H*W) product."""
    c = g.shapes[x][3]
    a = np.kron(_adaptive_avg_weights(h, gh), _adaptive_avg_weights(w, gw))
    return _resample(g, x, c, h * w, gh * gw, a)


def _upsample_tokens(g, t, h, w, gh, gw) -> str:
    """tokens (B, gh*gw, C) -> NHWC (B, H, W, C) by the bilinear
    matrices (half-pixel centres, edges clamped)."""
    b, _, c = g.shapes[t]
    a = np.kron(_bilinear_weights(gh, h), _bilinear_weights(gw, w))
    return g.reshape(_resample(g, t, c, gh * gw, h * w, a), (b, h, w, c))


def _emit_preln_block(g, x, blk, d, heads):
    b, n, _ = g.shapes[x]
    y = g.layernorm(x, blk.ln_input)
    dk = d // heads

    def proj(lin):
        q = g.reshape(g.linear(y, lin), (b, n, heads, dk))
        return g.transpose(q, (0, 2, 1, 3))       # (B,h,N,dk)
    q, k, v = (proj(blk.sa.que_proj), proj(blk.sa.key_proj),
               proj(blk.sa.val_proj))
    att = g.op("matmul", [q, g.transpose(k, (0, 1, 3, 2))])
    att = g.const_mul(att, 1.0 / math.sqrt(dk))
    att = g.op("softmax", [att])
    o = g.op("matmul", [att, v])                  # (B,h,N,dk)
    o = g.reshape(g.transpose(o, (0, 2, 1, 3)), (b, n, d))
    x = g.op("add", [x, g.linear(o, blk.sa.out_proj)])
    y = g.layernorm(x, blk.ln_output)
    y = g.op("gelu", [g.linear(y, blk.mlp[0])])
    return g.op("add", [x, g.linear(y, blk.mlp[2])])


def _emit_gpt(g, rgb, ir, mod, d, n_layer, h, w, gated, heads=8):
    """GPT / GPT1 / GPT1_fourier deploy dataflow: pool to 8x8 tokens,
    (GPT1: the channel gate), the token transformer over both streams,
    split, upsample back."""
    gh = gw = 8
    tr = _pool_tokens(g, rgb, h, w, gh, gw)
    ti = _pool_tokens(g, ir, h, w, gh, gw)
    if gated:
        k1 = np32(mod.conv1.weight)[:, :, 0, 0].T  # (C, 8)
        k2 = np32(mod.conv2.weight)[:, :, 0, 0].T  # (8, C)

        def gate(t):
            m = g.op("sigmoid", [g.dense(t, k1)])
            return g.op("mul", [g.dense(m, k2), t])
        tr, ti = gate(tr), gate(ti)
    t = g.op("concat", [tr, ti], axis=1)
    t = g.op("add", [t, g.const("pos", np32(mod.pos_emb))])
    for i in range(n_layer):
        t = _emit_preln_block(g, t, mod.trans_blocks[i], d, heads)
    t = g.layernorm(t, mod.ln_f)
    n = gh * gw
    return [_upsample_tokens(g, g.slice_axis(t, 1, 0, n), h, w, gh, gw),
            _upsample_tokens(g, g.slice_axis(t, 1, n, 2 * n), h, w, gh, gw)]


def _emit_detect(g, xs, mod, nc, anchors, strides, hw_list, decode):
    """Detect: per level the (B, na, ny, nx, no) output of the JAX head
    (``reshape(b, ny, nx, na, no).transpose(0, 3, 1, 2, 4)``), then the
    decode to (B, N, no); without ``decode`` the three level outputs."""
    na = len(anchors[0]) // 2
    no = nc + 5
    outs, levels = [], []
    for i, (x, (ny, nx)) in enumerate(zip(xs, hw_list)):
        b = g.shapes[x][0]
        y = g.conv(x, np32(mod.m[i].weight), np32(mod.m[i].bias),
                   pads=(0, 0, 0, 0))
        y = g.transpose(g.reshape(y, (b, ny, nx, na, no)), (0, 3, 1, 2, 4))
        levels.append(y)
        if not decode:
            continue
        z = g.op("sigmoid", [y])
        s = float(strides[i])
        grid, anchor = detect_grid(anchors[i], na, ny, nx)
        xy = g.slice_last(z, 0, 2)
        wh = g.slice_last(z, 2, 4)
        rest = g.slice_last(z, 4, no)
        xy = g.const_mul(g.op("add", [
            g.const_add(g.const_mul(xy, 2.0), -0.5),
            g.const("grid", grid)]), s)
        wh = g.const_mul(wh, 2.0)
        wh = g.op("mul", [g.op("mul", [wh, wh]), g.const("anc", anchor)])
        lvl = g.op("concat", [xy, wh, rest], axis=4)
        outs.append(g.reshape(lvl, (b, na * ny * nx, no)))
    return [g.op("concat", outs, axis=1)] if decode else levels


def emit_graph(spec: ModelSpec, model: torch.nn.Module, img: int,
               batch: int = 1, with_decode: bool = True,
               dtype: str = "float32") -> TFGraph:
    """The deploy forward of ``spec`` as a ``TFGraph`` on NHWC inputs
    ``(batch, img, img, 3)`` of ``dtype`` (``"float32"`` or
    ``"bfloat16"``; a bf16 input is cast to f32 first, as the JAX
    detector's ``rgb.astype(self.dtype)`` does), named ``rgb`` and ``ir``
    (a single-stream model's one input is ``rgb``).  ``model`` is the
    detector in any float form: a BN-folded copy of it is read, and
    ``model`` is left as it is.  The outputs are ``pred`` (B, N, 5+nc), or
    without ``with_decode`` the three levels' (B, na, ny, nx, no)."""
    from mmidet_tpu_torch.nn.fuse import fold_batchnorm
    if any(getattr(m, "quant", False) for m in model.modules()):
        raise ValueError(f"{WHAT}: the s8-storage (quantized) model has no "
                         "graph form; export its float model")
    folded = fold_batchnorm(copy.deepcopy(model).float().eval())
    two = is_two_stream(spec)
    g = Emitter()
    names = ("rgb", "ir") if two else ("rgb",)
    xs = []
    for name in names:
        shape = (batch, img, img, 3)
        g.shapes[name], g.dtypes[name] = shape, dtype
        xs.append(name if dtype == "float32"
                  else g.op("cast", [name], to="float32"))
    x = xs[0]
    if getattr(folded, "use_cem", False):
        x = emit_cem(g, x, folded.Enhance, 3)

    def gpt(inp, mod, rl, in_hw):
        h, w = in_hw[0]
        return _emit_gpt(g, inp[0], inp[1], mod, rl.args[0],
                         spec.fusion_layers, h, w, gated=rl.name != "GPT")

    def detect(inp, mod, rl, in_hw):
        return _emit_detect(g, list(inp), mod, rl.args[0], rl.args[1],
                            spec.strides, list(in_hw), with_decode)
    outs = walk(spec, folded, rows(g, gpt, detect), x,
                xs[1] if two else None, img, WHAT)
    return TFGraph([(n, (batch, img, img, 3), dtype) for n in names], outs,
                   g.ops, g.consts, g.shapes, g.dtypes)
