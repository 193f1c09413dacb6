"""NHWC graph of the deploy forward, for the SavedModel and TFLite legs.

Counterpart of what ``jax2tf`` lowers in ``mmidet_tpu/deploy/export.py``
(``export_savedmodel(native=False)``).  Like ``onnx_export``, the graph is
*emitted structurally*: ``emit_graph`` walks ``resolve(spec)`` with the
row walk and row emitters it shares with the ONNX emitter
(``deploy/rows.py``) over a BN-folded copy of the detector, and reads
each module's weights as f32 on the CPU.  The tensors are NHWC from the
inputs on (TF's CPU ``Conv2D`` and ``MaxPool`` take no NCHW, and TFLite
has no NCHW at all), and the weights are laid out as TF takes them: conv
filters HWIO (grouped: I the channels of a group), depthwise filters (H,
W, C, multiplier), matmul right-hand sides (in, out).

The result, a ``TFGraph``, is a list of primitive ops that both file
writers and the numpy runner understand, with every value's static shape:

  conv2d, depthwise_conv2d (x, filter[, bias]; ``stride``, an int or
  (h, w), ``pads`` (top, bottom, left, right)), add, sub, mul, div,
  squared_difference, sigmoid, relu, leaky_relu (``alpha``), hardswish,
  gelu (exact, erf), exp, log, concat (``axis``), max_pool (``k``,
  ``stride`` (default 1), ``padding`` SAME (default) or VALID),
  resize_nearest (``scale``; no corner alignment, no half-pixel centres),
  pad (``pads`` per dim, ``value``: 0 unless given, -inf before a max
  pool), reshape (``shape``), transpose (``perm``), reverse (``axis``),
  space_to_depth and depth_to_space (``block``), matmul (a, b[, bias];
  batched, broadcast), softmax (last axis), mean (``axes``, keepdims),
  rsqrt, strided_slice (``begin``, ``end``, ``strides``) and cast
  (``to``).

As in the ONNX graph the kernels play no part: the CEM, the fusion blocks
and their merges are the plain ops they compute, and GPT1_fourier's
inference graph is GPT1's.  The fusion blocks' average pool is the
constant matrix of ``nn/resize.py`` (as the JAX package computes it,
``mmidet_tpu/nn/fusion.py:43``), one matmul over the flattened map; the
GPT blocks' bilinear upsample is one such matmul too, and MambaFusion's
and a bilinear ``Upsample`` row's are two, one an axis (a map's one
matrix would grow as the square of its size).  Every row the JAX
detector takes has a form here, so every zoo model and every reference
YAML exports; beyond the ONNX leg's rows (``rows.py``) ``emit_graph``
adds MambaFusion (its causal conv a depthwise conv over a (B, 1, L, C)
view, its selective scan unrolled as ``linear_recurrence``'s rounds, the
backward stack on a ``reverse``), C3TR, BottleneckCSP, DWConv, GhostConv,
GhostBottleneck, MixConv2d, CrossConv, Contract and Expand (space to
depth and back, the JAX channel order), a bilinear Upsample,
``nn.MaxPool2d`` (strided, -inf padding) and ``nn.ZeroPad2d``.  A
BatchNorm the fold leaves (BottleneckCSP's, MixConv2d's, CrossConv's) is
a per-channel ``mul`` + ``add`` from its running statistics.  The
s8-storage (quantized) model raises ``ValueError``.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from mmidet_tpu_torch.deploy.rows import (UPSAMPLE_ROWS, detect_grid,
                                          emit_cem, np32, rows,
                                          upsample_mode, upsample_scale,
                                          walk)
from mmidet_tpu_torch.deploy.tf_proto import pair
from mmidet_tpu_torch.models.spec import ModelSpec, is_two_stream
from mmidet_tpu_torch.nn.layers import autopad
from mmidet_tpu_torch.nn.resize import (_adaptive_avg_weights,
                                        _bilinear_weights)

LN_EPS = 1e-5
WHAT = "SavedModel export"

UNARY = ("sigmoid", "relu", "leaky_relu", "hardswish", "gelu", "softmax",
         "rsqrt", "cast", "exp", "log", "reverse")
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
        sh, sw = pair(attrs["stride"])
        c = x[3] * co if kind == "depthwise_conv2d" else co
        return (x[0], _conv_out(x[1], kh, sh, t, b),
                _conv_out(x[2], kw, sw, le, r), c)
    if kind == "max_pool":
        k, s = attrs["k"], attrs.get("stride", 1)
        if attrs.get("padding", "SAME") == "SAME":
            return (x[0], -(-x[1] // s), -(-x[2] // s), x[3])
        return (x[0], _conv_out(x[1], k, s, 0, 0),
                _conv_out(x[2], k, s, 0, 0), x[3])
    if kind in UNARY:
        return tuple(x)
    if kind == "space_to_depth":
        s = attrs["block"]
        return (x[0], x[1] // s, x[2] // s, x[3] * s * s)
    if kind == "depth_to_space":
        s = attrs["block"]
        return (x[0], x[1] * s, x[2] * s, x[3] // (s * s))
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
             stride=1, pads=None, groups: int = 1) -> str:
        """An OIHW conv as ``depthwise_conv2d`` (one group an input channel,
        the multiplier ``co / groups``) or ``conv2d`` (any other groups:
        TF's ``Conv2D`` and TFLite's ``CONV_2D`` take a filter of the
        group's input channels); ``stride`` an int or (h, w), ``pads``
        (top, left, bottom, right) as the ONNX emitter takes them."""
        co, cig, kh, kw = kernel_oihw.shape
        if pads is None:
            p = autopad(kh)
            pads = (p, p, p, p)
        pads = (pads[0], pads[2], pads[1], pads[3])        # t, b, l, r
        sh, sw = pair(stride)
        stride = sh if sh == sw else (sh, sw)
        ins = [x]
        if groups > 1 and groups == self.shapes[x][3] and cig == 1:
            ins.append(self.const("w", kernel_oihw[:, 0].transpose(1, 2, 0)
                                  .reshape(kh, kw, groups, co // groups)))
            kind = "depthwise_conv2d"
        else:
            ins.append(self.const("w", kernel_oihw.transpose(2, 3, 1, 0)))
            kind = "conv2d"
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
        """SPP's and SPPF's pool: stride 1, SAME (-inf padding)."""
        return self.op("max_pool", [x], k=int(k))

    def pad(self, x: str, top: int, bottom: int, left: int, right: int,
            value: float = 0.0) -> str:
        pads = ((0, 0), (top, bottom), (left, right), (0, 0))
        if value == 0.0:
            return self.op("pad", [x], pads=pads)
        return self.op("pad", [x], pads=pads, value=float(value))

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


# ------------------------------------------- the rows beyond the ONNX leg's

def _bn(g, x, bn) -> str:
    """An eval-mode BatchNorm the fold leaves: ``x * scale + shift`` with
    scale = gamma / sqrt(var + eps), from its running statistics."""
    scale = np32(bn.weight) / np.sqrt(np32(bn.running_var) + bn.eps)
    shift = np32(bn.bias) - np32(bn.running_mean) * scale
    return g.op("add", [g.op("mul", [x, g.const("bns", scale)]),
                        g.const("bnb", shift)])


def _conv_mod(g, x, conv: torch.nn.Conv2d) -> str:
    """An ``nn.Conv2d`` by its own geometry (kernel, stride, padding,
    groups; its bias if it has one)."""
    ph, pw = conv.padding
    return g.conv(x, np32(conv.weight),
                  None if conv.bias is None else np32(conv.bias),
                  stride=conv.stride, pads=(ph, pw, ph, pw),
                  groups=conv.groups)


def _cba(g, x, mod, act="silu") -> str:
    """A ``ConvBnAct``, folded or with its BatchNorm kept."""
    y = _conv_mod(g, x, mod.conv)
    if mod.bn is not None:
        y = _bn(g, y, mod.bn)
    return g.act(y, act)


def _bottleneck(g, x, mod) -> str:
    y = _cba(g, _cba(g, x, mod.cv1), mod.cv2)
    return g.add(x, y) if mod.add else y


def _ghost_conv(g, x, mod, act="silu") -> str:
    y = _cba(g, x, mod.cv1, act)
    return g.concat([y, _cba(g, y, mod.cv2, act)])


def _ghost_bottleneck(g, x, mod) -> str:
    y = _ghost_conv(g, x, mod.conv1)
    if mod.dw is not None:
        y = _cba(g, y, mod.dw.conv, None)
    y = _ghost_conv(g, y, mod.conv2, None)
    sc = x if mod.stride != 2 else _cba(
        g, _cba(g, x, mod.sc_dw.conv, None), mod.sc_pw, None)
    return g.add(y, sc)


def _bottleneck_csp(g, x, mod) -> str:
    """cv1 -> the bottlenecks -> cv3 beside cv2, the kept BatchNorm over
    their concat, LeakyReLU 0.1, cv4."""
    y1 = _cba(g, x, mod.cv1)
    for b in mod.m:
        y1 = _bottleneck(g, y1, b)
    y = g.concat([_conv_mod(g, y1, mod.cv3), _conv_mod(g, x, mod.cv2)])
    return _cba(g, g.act(_bn(g, y, mod.bn), "leaky0.1"), mod.cv4)


def _mix_conv(g, x, mod) -> str:
    """One bias-free conv a kernel size over the whole input, the kept
    BatchNorm over their concat, ``x + leaky_relu(., 0.1)``."""
    y = _bn(g, g.concat([_conv_mod(g, x, m) for m in mod.m]), mod.bn)
    return g.add(x, g.act(y, "leaky0.1"))


def _cross_conv(g, x, mod) -> str:
    """(1, k) then (k, 1), their BatchNorms kept (``_ConvBnKept``)."""
    y = _cba(g, _cba(g, x, mod.cv1), mod.cv2)
    return g.add(x, y) if mod.add else y


def _vit_layer(g, x, layer) -> str:
    """LayerNorm-free ViT layer: q/k/v, then the attention's own biased
    projections, softmax(q k^T / sqrt(head_dim)) v, ``out``, residual;
    ``fc2(fc1(x)) + x``."""
    b, n, c = g.shapes[x]
    heads = layer.num_heads
    dk = c // heads

    def proj(pre, lin):
        t = g.reshape(g.linear(g.linear(x, pre), lin), (b, n, heads, dk))
        return g.transpose(t, (0, 2, 1, 3))       # (B, h, N, dk)
    q, k, v = (proj(layer.q, layer.ma.query), proj(layer.k, layer.ma.key),
               proj(layer.v, layer.ma.value))
    att = g.op("matmul", [q, g.transpose(k, (0, 1, 3, 2))])
    att = g.op("softmax", [g.const_mul(att, 1.0 / math.sqrt(dk))])
    o = g.reshape(g.transpose(g.op("matmul", [att, v]), (0, 2, 1, 3)),
                  (b, n, c))
    x = g.add(g.linear(o, layer.ma.out), x)
    return g.add(g.linear(g.linear(x, layer.fc1), layer.fc2), x)


def _c3tr(g, x, mod) -> str:
    """C3 with ``VitTransformerBlock`` inside: its conv where c1 != c2,
    the flattened tokens plus their linear position term, the layers."""
    blk = mod.m
    y1 = _cba(g, x, mod.cv1)
    if blk.conv is not None:
        y1 = _cba(g, y1, blk.conv)
    b, h, w, c = g.shapes[y1]
    p = g.reshape(y1, (b, h * w, c))
    p = g.add(p, g.linear(p, blk.linear))
    for layer in blk.tr:
        p = _vit_layer(g, p, layer)
    y1 = g.reshape(p, (b, h, w, c))
    return _cba(g, g.concat([y1, _cba(g, x, mod.cv2)]), mod.cv3)


def _bilinear(g, x, ho: int, wo: int) -> str:
    """NHWC bilinear resize (half-pixel centres, edges clamped): the
    (out, in) matrices of ``nn/resize.py`` one axis at a time, each a
    matmul over the axis brought last."""
    _, hi, wi, _ = g.shapes[x]
    y = g.dense(g.transpose(x, (0, 1, 3, 2)),
                _bilinear_weights(wi, wo).T)         # (B, H, C, wo)
    y = g.dense(g.transpose(y, (0, 3, 2, 1)),
                _bilinear_weights(hi, ho).T)         # (B, wo, C, ho)
    return g.transpose(y, (0, 3, 1, 2))


def _upsample_any(g, x, rl) -> str:
    scale = upsample_scale(rl)
    if upsample_mode(rl) == "nearest":
        return g.upsample(x, scale)
    _, h, w, _ = g.shapes[x]
    return _bilinear(g, x, h * scale, w * scale)


def _max_pool_row(g, x, rl) -> str:
    """torch ``nn.MaxPool2d(k, s, p)`` as the JAX detector computes it:
    -inf padding (``PadV2``), then a VALID pool."""
    a = rl.args
    k = a[0]
    s = a[1] if len(a) > 1 and a[1] else k
    p = a[2] if len(a) > 2 else 0
    if p:
        x = g.pad(x, p, p, p, p, value=-np.inf)
    return g.op("max_pool", [x], k=int(k), stride=int(s), padding="VALID")


def _rmsnorm(g, x, norm) -> str:
    ms = g.op("mean", [g.op("mul", [x, x])], axes=(-1,))
    r = g.op("rsqrt", [g.const_add(ms, norm.eps)])
    return g.op("mul", [g.op("mul", [x, r]), g.const("rms",
                                                     np32(norm.weight))])


def _softplus(g, x) -> str:
    """max(x, 0) + log(1 + exp(-|x|)), with -|x| = x - 2 max(x, 0): no
    overflow, and builtins only (TFLite has no LOG1P or SOFTPLUS).  The
    port's ``F.softplus`` returns x above 20 and ``jax.nn.softplus`` does
    not: the two differ there by under 2.1e-9."""
    r = g.op("relu", [x])
    e = g.op("exp", [g.op("sub", [x, g.const_mul(r, 2.0)])])
    return g.op("add", [r, g.op("log", [g.const_add(e, 1.0)])])


def _scan(g, a, x) -> str:
    """``nn/mamba.py:linear_recurrence`` unrolled: h[t] = a[t] h[t-1] +
    x[t] over axis 1 by its ceil(log2 L) rounds, each slices, a product
    and a concat (no loop op)."""
    n, s = g.shapes[a][1], 1
    while s < n:
        head = g.slice_axis(x, 1, 0, s)
        prod = g.op("mul", [g.slice_axis(a, 1, s, n),
                            g.slice_axis(x, 1, 0, n - s)])
        x = g.op("concat", [head, g.add(prod, g.slice_axis(x, 1, s, n))],
                 axis=1)
        if 2 * s < n:  # the last round's products of a are not read
            a = g.op("concat", [g.slice_axis(a, 1, 0, s), g.op("mul", [
                g.slice_axis(a, 1, s, n), g.slice_axis(a, 1, 0, n - s)])],
                axis=1)
        s *= 2
    return x


def _mamba_block(g, x, blk) -> str:
    """``MambaBlock`` on (B, L, d): in_proj's halves, the causal depthwise
    conv (left pad d_conv - 1 over a (B, 1, L, d_inner) view) and SiLU,
    x_proj's three parts, dt_proj and softplus, exp(delta A), the scan,
    the readout against C (a batched matmul summing d_state), D x, the
    SiLU gate, out_proj."""
    cfg = blk.cfg
    b, n_tok, _ = g.shapes[x]
    di, n, rank = cfg.d_inner, cfg.d_state, cfg.rank
    w_in = np32(blk.in_proj.weight)                     # (2 di, d)
    xs, z = g.dense(x, w_in[:di].T), g.dense(x, w_in[di:].T)
    kern = np32(blk.conv1d_kernel)[:, 0, :].T[:, None, None, :]
    xc = g.conv(g.reshape(xs, (b, 1, n_tok, di)), kern,
                np32(blk.conv1d_bias), pads=(0, cfg.d_conv - 1, 0, 0),
                groups=di)
    xc = g.act(g.reshape(xc, (b, n_tok, di)), "silu")
    w_x = np32(blk.x_proj.weight)                       # (rank + 2n, di)
    dt = g.dense(xc, w_x[:rank].T)
    bm = g.dense(xc, w_x[rank:rank + n].T)
    cm = g.dense(xc, w_x[rank + n:].T)
    delta = _softplus(g, g.linear(dt, blk.dt_proj))     # (B, L, di)
    a = -np.exp(np32(blk.A_log))                        # (di, n)
    da = g.op("exp", [g.op("mul", [g.reshape(delta, (b, n_tok, di, 1)),
                                   g.const("A", a)])])
    dbx = g.op("mul", [g.reshape(g.op("mul", [delta, xc]),
                                 (b, n_tok, di, 1)),
                       g.reshape(bm, (b, n_tok, 1, n))])
    h = _scan(g, da, dbx)                               # (B, L, di, n)
    y = g.reshape(g.op("matmul", [h, g.reshape(cm, (b, n_tok, n, 1))]),
                  (b, n_tok, di))
    y = g.add(y, g.op("mul", [xc, g.const("D", np32(blk.D))]))
    return g.linear(g.op("mul", [y, g.act(z, "silu")]), blk.out_proj)


def _mamba(g, x, stack) -> str:
    for layer in stack.layers:
        x = g.add(x, _mamba_block(g, _rmsnorm(g, x, layer.norm),
                                  layer.mixer))
    return x


def _emit_mamba_fusion(g, rgb, ir, mod, h, w) -> list[str]:
    """``MambaFusion``: both streams pooled to the grid's tokens (the RGB
    tokens first), the forward stack plus the backward stack on the
    reversed sequence, reversed back, ``norm_f``, each half resized back
    to (h, w)."""
    gh, gw = mod.grid
    t = g.op("concat", [_pool_tokens(g, rgb, h, w, gh, gw),
                        _pool_tokens(g, ir, h, w, gh, gw)], axis=1)
    bwd = _mamba(g, g.op("reverse", [t], axis=1), mod.bwd)
    out = g.add(_mamba(g, t, mod.fwd), g.op("reverse", [bwd], axis=1))
    out = _rmsnorm(g, out, mod.norm_f)
    b, _, c = g.shapes[out]
    n = gh * gw
    return [_bilinear(g, g.reshape(g.slice_axis(out, 1, lo, lo + n),
                                   (b, gh, gw, c)), h, w)
            for lo in (0, n)]


def _repeated(g, fn):
    """A handler of a row whose ``n > 1`` copies chain (the detector's
    ``nn.Sequential``)."""
    def handler(inp, mod, rl, hw):
        x = inp
        for m in (list(mod) if isinstance(mod, torch.nn.Sequential)
                  else [mod]):
            x = fn(g, x, m, rl)
        return x
    return handler


def _act_arg(rl, i: int):
    return rl.args[i] if len(rl.args) > i else "silu"


def tf_rows(g) -> dict:
    """The handlers of the rows only the TF legs take (the JAX package's
    ONNX emitter refuses them, ``mmidet_tpu/deploy/onnx_export.py:454,
    470``), and the Upsample rows in both modes."""
    table = {
        "DWConv": _repeated(g, lambda g, x, m, rl: _cba(g, x, m.conv,
                                                        _act_arg(rl, 3))),
        "GhostConv": _repeated(g, lambda g, x, m, rl: _ghost_conv(
            g, x, m, _act_arg(rl, 3))),
        "GhostBottleneck": _repeated(
            g, lambda g, x, m, rl: _ghost_bottleneck(g, x, m)),
        "CrossConv": _repeated(g, lambda g, x, m, rl: _cross_conv(g, x, m)),
        "MixConv2d": _repeated(g, lambda g, x, m, rl: _mix_conv(g, x, m)),
        "BottleneckCSP": _repeated(
            g, lambda g, x, m, rl: _bottleneck_csp(g, x, m)),
        "C3TR": _repeated(g, lambda g, x, m, rl: _c3tr(g, x, m)),
        "nn.MaxPool2d": lambda inp, mod, rl, hw: _max_pool_row(g, inp, rl),
        "nn.ZeroPad2d": lambda inp, mod, rl, hw: g.pad(
            inp, rl.args[0][2], rl.args[0][3], rl.args[0][0],
            rl.args[0][1]),
        "Contract": lambda inp, mod, rl, hw: g.op(
            "space_to_depth", [inp], block=int(rl.args[0])),
        "Expand": lambda inp, mod, rl, hw: g.op(
            "depth_to_space", [inp], block=int(rl.args[0])),
        "MambaFusion": lambda inp, mod, rl, hw: _emit_mamba_fusion(
            g, inp[0], inp[1], mod, *hw[0]),
    }
    table.update({m: lambda inp, mod, rl, hw: _upsample_any(g, inp, rl)
                  for m in UPSAMPLE_ROWS})
    return table


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
    table = rows(g, gpt, detect)
    table.update(tf_rows(g))

    def hw_of(v):
        v = v[0] if isinstance(v, list) else v
        return tuple(g.shapes[v][1:3])
    outs = walk(spec, folded, table, x, xs[1] if two else None, img, WHAT,
                hw_of=hw_of)
    return TFGraph([(n, (batch, img, img, 3), dtype) for n in names], outs,
                   g.ops, g.consts, g.shapes, g.dtypes)
