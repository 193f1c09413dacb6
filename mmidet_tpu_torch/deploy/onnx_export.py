"""ONNX export of the two-stream / single-stream deploy forward.

Counterpart of ``mmidet_tpu/deploy/onnx_export.py``; reference
``models/export.py:83-99``.  The graph is *emitted structurally*, not
traced: ``export_onnx`` walks ``resolve(spec)`` and reads each row's
``nn.Module`` of the BN-folded f32 detector (``fold_batchnorm``), one
emitter per module class, NCHW tensors.  It is the JAX package's emitter
with the port's OIHW weights in place of HWIO: the same rows, the same
node sequence, op types, attributes and names, and for bridged weights
the same initializers to the bit.

The graph is the full deploy dataflow including the on-graph Detect
decode, producing ``pred (B, N, 5+nc)``, the tensor NMS takes.  The
fourier branch of GPT1_fourier feeds only the training-time separation
loss, so its inference graph is GPT1's (no FFT ops).  The kernels play no
part here: the CEM, the fusion blocks and their merges are emitted as the
plain ops they compute.

Serialization is the port's own codec (``onnx_proto``; no onnx wheel);
``onnx_np`` runs the file in numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmidet_tpu_torch.deploy.onnx_proto import (FLOAT, Graph, Model, Node,
                                                Tensor, ValueInfo)
from mmidet_tpu_torch.models.spec import (SECOND_INPUT, ModelSpec,
                                          is_two_stream, resolve)
from mmidet_tpu_torch.nn.cem import edge_filter_bank
from mmidet_tpu_torch.nn.layers import autopad
from mmidet_tpu_torch.nn.resize import (_adaptive_avg_weights,
                                        _bilinear_weights)

LN_EPS = 1e-5


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


class _Emitter:
    def __init__(self):
        self.nodes: list[Node] = []
        self.inits: list[Tensor] = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self.inits.append(Tensor(name, np.ascontiguousarray(arr)))
        return name

    def op(self, op_type: str, inputs: list[str], n_out: int = 1,
           **attrs) -> str | list[str]:
        outs = [self.fresh(op_type.lower()) for _ in range(n_out)]
        self.nodes.append(Node(op_type, list(inputs), outs,
                               name=self.fresh(op_type), attrs=attrs))
        return outs[0] if n_out == 1 else outs

    # ---- common composites ------------------------------------------
    def conv(self, x: str, kernel_oihw: np.ndarray, bias: np.ndarray | None,
             stride: int = 1, pads=None, groups: int = 1) -> str:
        w = self.init("w", kernel_oihw.astype(np.float32))
        kh, kw = kernel_oihw.shape[2], kernel_oihw.shape[3]
        if pads is None:
            p = autopad(kh)
            pads = (p, p, p, p)
        ins = [x, w]
        if bias is not None:
            ins.append(self.init("b", bias.astype(np.float32)))
        return self.op("Conv", ins, strides=[stride, stride],
                       pads=list(pads), group=groups,
                       kernel_shape=[kh, kw])

    def act(self, x: str, name: str | None) -> str:
        if name in (None, "identity"):
            return x
        if name == "silu":
            return self.op("Mul", [x, self.op("Sigmoid", [x])])
        if name == "leaky0.1":
            return self.op("LeakyRelu", [x], alpha=0.1)
        if name == "relu":
            return self.op("Relu", [x])
        if name == "hardswish":
            return self.op("HardSwish", [x])
        raise ValueError(f"ONNX export: unsupported activation {name!r}")

    def matmul(self, a: str, b: str) -> str:
        return self.op("MatMul", [a, b])

    def dense(self, x: str, lin: torch.nn.Linear) -> str:
        """``nn.Linear``: MatMul by the (in, out) kernel, then Add."""
        y = self.matmul(x, self.init("dk", _np(lin.weight).T))
        if lin.bias is not None:
            y = self.op("Add", [y, self.init("db", _np(lin.bias))])
        return y

    def reshape(self, x: str, shape) -> str:
        s = self.init("shape", np.asarray([int(v) for v in shape], np.int64))
        return self.op("Reshape", [x, s])

    def transpose(self, x: str, perm) -> str:
        return self.op("Transpose", [x], perm=[int(v) for v in perm])

    def slice_(self, x: str, starts, ends, axes) -> str:
        return self.op("Slice", [
            x, self.init("st", np.asarray(starts, np.int64)),
            self.init("en", np.asarray(ends, np.int64)),
            self.init("ax", np.asarray(axes, np.int64))])

    def const_mul(self, x: str, v: float) -> str:
        return self.op("Mul", [x, self.init("c", np.float32(v).reshape(()))])

    def const_add(self, x: str, v: float) -> str:
        return self.op("Add", [x, self.init("c", np.float32(v).reshape(()))])

    def layernorm(self, x: str, ln: torch.nn.LayerNorm) -> str:
        return self.op("LayerNormalization", [
            x, self.init("lns", _np(ln.weight)),
            self.init("lnb", _np(ln.bias))], axis=-1, epsilon=LN_EPS)

    def gelu_exact(self, x: str) -> str:
        e = self.op("Erf", [self.const_mul(x, 1.0 / math.sqrt(2.0))])
        return self.const_mul(self.op("Mul", [x, self.const_add(e, 1.0)]),
                              0.5)


def _conv_of(mod) -> tuple[np.ndarray, np.ndarray]:
    """A folded ``ConvBnAct``'s OIHW kernel and bias."""
    if mod.bn is not None or mod.conv.bias is None:
        raise ValueError("ONNX export needs the BN-folded model "
                         "(fold_batchnorm)")
    return _np(mod.conv.weight), _np(mod.conv.bias)


# ------------------------------------------------------------- emitters

def _emit_convbnact(g, x, mod, args):
    """Folded ``ConvBnAct``; args = (c2, k=1, s=1, pad=None, groups=1,
    act='silu')."""
    k = args[1] if len(args) > 1 else 1
    s = args[2] if len(args) > 2 else 1
    pad = args[3] if len(args) > 3 else None
    groups = args[4] if len(args) > 4 else 1
    act = args[5] if len(args) > 5 else "silu"
    pp = autopad(k, pad)
    pp = (pp, pp) if isinstance(pp, int) else tuple(pp)
    w, b = _conv_of(mod)
    y = g.conv(x, w, b, stride=s, pads=(pp[0], pp[1], pp[0], pp[1]),
               groups=groups)
    return g.act(y, act)


def _emit_focus(g, x, mod, args):
    """Folded Focus: its space-to-depth conv rearranged into one
    (2k, 2k) stride-2 conv on the image, as the JAX emitter writes it."""
    w, b = _conv_of(mod.conv)
    kern = w.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
    k = kern.shape[0]
    c1 = kern.shape[2] // 4
    co = kern.shape[3]
    act = args[2] if len(args) > 2 else "silu"
    if isinstance(act, int):  # positional (features, k, s, act) unlikely
        act = "silu"
    p_ = autopad(k)
    w = kern.reshape(k, k, 2, 2, c1, co)
    big = np.zeros((2 * k, 2 * k, c1, co), np.float32)
    for rg in range(2):
        for sg in range(2):
            big[rg::2, sg::2] = w[:, :, sg, rg]
    y = g.conv(x, big.transpose(3, 2, 0, 1), b, stride=2,
               pads=(2 * p_, 2 * p_, 2 * p_, 2 * p_))
    return g.act(y, "silu" if not isinstance(act, str) else act)


def _emit_bottleneck(g, x, mod, features, shortcut, c_in):
    y = _emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    y = _emit_convbnact(g, y, mod.cv2, (None, 3, 1))
    if shortcut and c_in == features:
        return g.op("Add", [x, y])
    return y


def _emit_c3(g, x, mod, args):
    c2 = args[0]
    n = args[1] if len(args) > 1 else 1
    shortcut = args[2] if len(args) > 2 else True
    c_ = int(c2 * 0.5)
    y1 = _emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    for i in range(n):
        y1 = _emit_bottleneck(g, y1, mod.m[i], c_, shortcut, c_)
    y2 = _emit_convbnact(g, x, mod.cv2, (None, 1, 1))
    y = g.op("Concat", [y1, y2], axis=1)
    return _emit_convbnact(g, y, mod.cv3, (None, 1, 1))


def _emit_spp(g, x, mod, kernels):
    x = _emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    ys = [x]
    for k in kernels:
        ph = k // 2
        ys.append(g.op("MaxPool", [x], kernel_shape=[k, k],
                       strides=[1, 1], pads=[ph, ph, ph, ph]))
    y = g.op("Concat", ys, axis=1)
    return _emit_convbnact(g, y, mod.cv2, (None, 1, 1))


def _emit_sppf(g, x, mod, k):
    x = _emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    ph = k // 2
    y1 = g.op("MaxPool", [x], kernel_shape=[k, k], strides=[1, 1],
              pads=[ph, ph, ph, ph])
    y2 = g.op("MaxPool", [y1], kernel_shape=[k, k], strides=[1, 1],
              pads=[ph, ph, ph, ph])
    y3 = g.op("MaxPool", [y2], kernel_shape=[k, k], strides=[1, 1],
              pads=[ph, ph, ph, ph])
    y = g.op("Concat", [x, y1, y2, y3], axis=1)
    return _emit_convbnact(g, y, mod.cv2, (None, 1, 1))


def _emit_upsample(g, x, scale):
    return g.op("Resize",
                [x, "", g.init("sc", np.asarray([1, 1, scale, scale],
                                                np.float32))],
                mode="nearest", nearest_mode="floor",
                coordinate_transformation_mode="asymmetric")


def _emit_cem(g, x, mod, c):
    """Folded ContourEnhance: conv2 + leaky, the edge bank (ONE full
    (8c, 8c) constant conv: output channel o carries kernel o % 8 on every
    input channel, scaled by its factor), residual, conv3 + leaky,
    residual."""
    if mod.bn2 is not None or mod.bn3 is not None:
        raise ValueError("ONNX export needs the BN-folded model "
                         "(fold_batchnorm)")
    y = g.conv(x, _np(mod.conv2.weight), _np(mod.conv2.bias),
               stride=1, pads=(1, 1, 1, 1))
    y = g.act(y, "leaky0.1")
    c8 = 8 * c
    bank = edge_filter_bank(c8, c8, 3)           # (3,3,in=8c,out=8c) HWIO
    factor = _np(mod.sobel.sobel_factor).reshape(-1)
    e = g.conv(y, np.transpose(bank * factor[None, None, None, :],
                               (3, 2, 0, 1)),
               _np(mod.sobel.bias), stride=1, pads=(1, 1, 1, 1))
    y = g.op("Add", [y, e])
    y = g.conv(y, _np(mod.conv3.weight), _np(mod.conv3.bias),
               stride=1, pads=(1, 1, 1, 1))
    y = g.act(y, "leaky0.1")
    return g.op("Add", [y, x])


def _pool_matmul(g, x, h, w, gh, gw, kind):
    """NCHW (B,C,H,W) -> (B,C,gh,gw) by the constant resampling matrices
    (``nn/resize.py``); MatMul broadcasts over (B,C)."""
    wfun = _adaptive_avg_weights if kind == "avg" else _bilinear_weights
    a_h = wfun(h, gh)                             # (gh, H)
    a_w = wfun(w, gw)                             # (gw, W)
    y = g.matmul(g.init("ah", a_h), x)            # (gh,H)@(B,C,H,W)
    return g.matmul(y, g.init("awt", a_w.T.copy()))


def _tokens_from_map(g, x, c, gh, gw):
    """(B,C,gh,gw) -> (B, gh*gw, C)."""
    y = g.reshape(x, (0, c, gh * gw))             # 0 = copy dim (Reshape)
    return g.transpose(y, (0, 2, 1))


def _map_from_tokens(g, t, c, gh, gw):
    y = g.transpose(t, (0, 2, 1))
    return g.reshape(y, (0, c, gh, gw))


def _emit_preln_block(g, x, blk, d, heads):
    y = g.layernorm(x, blk.ln_input)
    dk = d // heads

    def proj(lin):
        q = g.dense(y, lin)
        q = g.reshape(q, (0, -1, heads, dk))
        return g.transpose(q, (0, 2, 1, 3))       # (B,h,N,dk)
    q, k, v = (proj(blk.sa.que_proj), proj(blk.sa.key_proj),
               proj(blk.sa.val_proj))
    att = g.matmul(q, g.transpose(k, (0, 1, 3, 2)))
    att = g.const_mul(att, 1.0 / math.sqrt(dk))
    att = g.op("Softmax", [att], axis=-1)
    o = g.matmul(att, v)                          # (B,h,N,dk)
    o = g.transpose(o, (0, 2, 1, 3))
    o = g.reshape(o, (0, -1, d))
    o = g.dense(o, blk.sa.out_proj)
    x = g.op("Add", [x, o])
    y = g.layernorm(x, blk.ln_output)
    y = g.dense(y, blk.mlp[0])
    y = g.gelu_exact(y)
    y = g.dense(y, blk.mlp[2])
    return g.op("Add", [x, y])


def _emit_token_transformer(g, rgb_p, ir_p, mod, d, n_layer, gh, gw,
                            heads=8):
    """``_TokenTransformer``: tokens -> pos_emb -> blocks -> ln_f ->
    split."""
    tr = _tokens_from_map(g, rgb_p, d, gh, gw)
    ti = _tokens_from_map(g, ir_p, d, gh, gw)
    t = g.op("Concat", [tr, ti], axis=1)
    t = g.op("Add", [t, g.init("pos", _np(mod.pos_emb))])
    for i in range(n_layer):
        t = _emit_preln_block(g, t, mod.trans_blocks[i], d, heads)
    t = g.layernorm(t, mod.ln_f)
    n = gh * gw
    tr = g.slice_(t, [0], [n], [1])
    ti = g.slice_(t, [n], [2 * n], [1])
    return (_map_from_tokens(g, tr, d, gh, gw),
            _map_from_tokens(g, ti, d, gh, gw))


def _emit_gpt(g, rgb, ir, mod, d, n_layer, h, w, gated):
    """GPT / GPT1 / GPT1_fourier deploy dataflow (GPT1_fourier's inference
    graph is GPT1's)."""
    gh = gw = 8
    rgb_p = _pool_matmul(g, rgb, h, w, gh, gw, "avg")
    ir_p = _pool_matmul(g, ir, h, w, gh, gw, "avg")
    if gated:
        k1 = _np(mod.conv1.weight)                # (8,C,1,1)
        k2 = _np(mod.conv2.weight)                # (C,8,1,1)

        def gate(x):
            m = g.op("Sigmoid", [g.conv(x, k1, None, pads=(0, 0, 0, 0))])
            return g.op("Mul", [g.conv(m, k2, None, pads=(0, 0, 0, 0)), x])
        rgb_p, ir_p = gate(rgb_p), gate(ir_p)
    ro, io = _emit_token_transformer(g, rgb_p, ir_p, mod, d, n_layer, gh,
                                     gw)
    return (_pool_matmul(g, ro, gh, gw, h, w, "bilinear"),
            _pool_matmul(g, io, gh, gw, h, w, "bilinear"))


def _emit_detect(g, xs, mod, nc, anchors, strides, hw_list):
    """Detect + on-graph decode."""
    na = len(anchors[0]) // 2
    no = nc + 5
    outs = []
    for i, (x, (ny, nx)) in enumerate(zip(xs, hw_list)):
        y = g.conv(x, _np(mod.m[i].weight), _np(mod.m[i].bias),
                   pads=(0, 0, 0, 0))
        # NCHW (B, na*no, ny, nx) -> (B, na, no, ny, nx) -> (B,na,ny,nx,no)
        y = g.reshape(y, (0, na, no, ny, nx))
        y = g.transpose(y, (0, 1, 3, 4, 2))
        z = g.op("Sigmoid", [y])
        s = float(strides[i])
        gy, gx = np.meshgrid(np.arange(ny, dtype=np.float32),
                             np.arange(nx, dtype=np.float32), indexing="ij")
        grid = np.stack([gx, gy], -1)[None, None]            # (1,1,ny,nx,2)
        anchor = np.asarray(anchors[i], np.float32).reshape(1, na, 1, 1, 2)
        xy = g.slice_(z, [0], [2], [4])
        wh = g.slice_(z, [2], [4], [4])
        rest = g.slice_(z, [4], [no], [4])
        xy = g.const_mul(g.op("Add", [
            g.const_add(g.const_mul(xy, 2.0), -0.5),
            g.init("grid", grid)]), s)
        wh = g.const_mul(wh, 2.0)
        wh = g.op("Mul", [g.op("Mul", [wh, wh]), g.init("anc", anchor)])
        lvl = g.op("Concat", [xy, wh, rest], axis=4)
        outs.append(g.reshape(lvl, (0, na * ny * nx, no)))
    return g.op("Concat", outs, axis=1)


# --------------------------------------------------------------- export

def export_onnx(spec: ModelSpec, model: torch.nn.Module, img: int,
                path: str, use_cem: bool = True,
                batch: int | str = "batch") -> Model:
    """Emit the deploy forward of ``spec`` from ``model``, the BN-FOLDED
    ``TwoStreamDetector`` (``fold_batchnorm``; its weights are read as
    f32 on the CPU), as an ONNX model and save it to ``path``.

    Two-stream specs take inputs ``rgb``/``ir`` (B,3,img,img); single-
    stream, ``images``.  Output ``pred`` is (B, N, 5+nc), the detector's
    decoded prediction.  A row the emitter has no form for (MambaFusion,
    a bilinear Upsample, the other layer rows) raises ``ValueError``."""
    resolved, save = resolve(spec)
    two = is_two_stream(spec)
    g = _Emitter()

    hw = {}          # layer index -> (ny, nx) spatial dims

    def hw_of(name_idx, cur):
        return hw.get(name_idx, cur)

    x = "rgb" if two else "images"
    inputs = [ValueInfo(x, FLOAT, (batch, 3, img, img))]
    if two:
        inputs.append(ValueInfo("ir", FLOAT, (batch, 3, img, img)))
    x2 = "ir" if two else None
    if use_cem:
        x = _emit_cem(g, x, model.Enhance, 3)

    cur_hw = (img, img)
    hw2 = (img, img)
    y: dict[int, object] = {}
    pred = None
    for rl, mod in zip(resolved, model.model):
        m = rl.name

        def get(j):
            if j == -1:
                return x
            if j == SECOND_INPUT:
                return x2
            return y[j]

        if isinstance(rl.f, tuple):
            inp = [get(j) for j in rl.f]
            in_hw = [hw_of(j, cur_hw) if j not in (-1, SECOND_INPUT)
                     else (cur_hw if j == -1 else hw2) for j in rl.f]
        else:
            inp = get(rl.f)
            in_hw = (cur_hw if rl.f == -1
                     else hw2 if rl.f == SECOND_INPUT
                     else hw_of(rl.f, cur_hw))

        if m == "Conv":
            stride = rl.args[2] if len(rl.args) > 2 else 1
            x = _emit_convbnact(g, inp, mod, rl.args)
            cur_hw = (in_hw[0] // stride, in_hw[1] // stride)
        elif m == "Focus":
            x = _emit_focus(g, inp, mod, rl.args)
            cur_hw = (in_hw[0] // 2, in_hw[1] // 2)
        elif m == "C3":
            x = _emit_c3(g, inp, mod, rl.args)
            cur_hw = in_hw
        elif m == "Bottleneck":
            sc = rl.args[1] if len(rl.args) > 1 else True
            # n > 1: sequential repeats (hub yolov3), model.{i}.{r}
            copies = list(mod) if rl.n > 1 else [mod]
            x = inp
            for copy in copies:
                x = _emit_bottleneck(g, x, copy, rl.args[0], sc, rl.args[0])
            cur_hw = in_hw
        elif m == "SPP":
            x = _emit_spp(g, inp, mod, rl.args[1] if len(rl.args) > 1
                          else (5, 9, 13))
            cur_hw = in_hw
        elif m == "SPPF":
            x = _emit_sppf(g, inp, mod, rl.args[1] if len(rl.args) > 1
                           else 5)
            cur_hw = in_hw
        elif m == "Concat":
            x = g.op("Concat", list(inp), axis=1)
            cur_hw = in_hw[0]
        elif m == "Add":
            x = g.op("Add", [inp[0], inp[1]])
            cur_hw = in_hw[0]
        elif m == "Add2":
            x = g.op("Add", [inp[0], inp[1][rl.args[0]]])
            cur_hw = in_hw[0]
        elif m in ("Upsample", "nn.Upsample"):
            scale = int(rl.args[1]) if len(rl.args) >= 2 and rl.args[1] else 2
            mode = rl.args[2] if len(rl.args) >= 3 and isinstance(
                rl.args[2], str) else "nearest"
            if mode != "nearest":
                raise ValueError("ONNX export: only nearest upsample")
            x = _emit_upsample(g, inp, scale)
            cur_hw = (in_hw[0] * scale, in_hw[1] * scale)
        elif m in ("GPT", "GPT1", "GPT1_fourier"):
            h, w = in_hw[0]
            ro, io = _emit_gpt(g, inp[0], inp[1], mod, rl.args[0],
                               spec.fusion_layers, h, w, gated=m != "GPT")
            x = [ro, io]
            cur_hw = in_hw[0]
        elif m == "Detect":
            pred = _emit_detect(g, list(inp), mod, rl.args[0], rl.args[1],
                                spec.strides, list(in_hw))
            x = pred
            cur_hw = in_hw[0]
        else:
            raise ValueError(f"ONNX export: unhandled module {m!r} "
                             f"(layer {rl.index})")

        if rl.index in save:
            y[rl.index] = x
            hw[rl.index] = cur_hw

    if pred is None:
        raise ValueError("spec has no Detect layer")
    na = spec.na
    n_pred = sum(na * (img // s) ** 2 for s in spec.strides)
    g.nodes[-1].outputs[-1] = "pred"  # the last node; nothing consumes it
    graph = Graph("mmidet", g.nodes, inputs,
                  [ValueInfo("pred", FLOAT, (batch, n_pred, spec.nc + 5))],
                  g.inits)
    out = Model(graph, doc=f"mmidet_tpu_torch deploy export img={img}")
    out.save(path)
    return out
