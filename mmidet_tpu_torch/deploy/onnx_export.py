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

The row walk and the rows whose ops do not depend on the layout are
``deploy/rows.py``'s, which ``tf_graph`` (the NHWC emitter of the
SavedModel and TFLite legs) shares.  Serialization is the
port's own codec (``onnx_proto``; no onnx wheel);
``onnx_np`` runs the file in numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmidet_tpu_torch.deploy.onnx_proto import (FLOAT, Graph, Model, Node,
                                                Tensor, ValueInfo)
from mmidet_tpu_torch.deploy.rows import (detect_grid, emit_cem, np32,
                                          rows, walk)
from mmidet_tpu_torch.models.spec import ModelSpec, is_two_stream
from mmidet_tpu_torch.nn.layers import autopad
from mmidet_tpu_torch.nn.resize import (_adaptive_avg_weights,
                                        _bilinear_weights)

LN_EPS = 1e-5


class _Emitter:
    what = "ONNX export"

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

    def add(self, a: str, b: str) -> str:
        return self.op("Add", [a, b])

    def concat(self, xs: list[str]) -> str:
        return self.op("Concat", list(xs), axis=1)

    def max_pool(self, x: str, k: int) -> str:
        """Stride 1, the size kept."""
        ph = k // 2
        return self.op("MaxPool", [x], kernel_shape=[k, k], strides=[1, 1],
                       pads=[ph, ph, ph, ph])

    def upsample(self, x: str, scale: int) -> str:
        return self.op("Resize",
                       [x, "", self.init("sc", np.asarray(
                           [1, 1, scale, scale], np.float32))],
                       mode="nearest", nearest_mode="floor",
                       coordinate_transformation_mode="asymmetric")

    def matmul(self, a: str, b: str) -> str:
        return self.op("MatMul", [a, b])

    def dense(self, x: str, lin: torch.nn.Linear) -> str:
        """``nn.Linear``: MatMul by the (in, out) kernel, then Add."""
        y = self.matmul(x, self.init("dk", np32(lin.weight).T))
        if lin.bias is not None:
            y = self.op("Add", [y, self.init("db", np32(lin.bias))])
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
            x, self.init("lns", np32(ln.weight)),
            self.init("lnb", np32(ln.bias))], axis=-1, epsilon=LN_EPS)

    def gelu_exact(self, x: str) -> str:
        e = self.op("Erf", [self.const_mul(x, 1.0 / math.sqrt(2.0))])
        return self.const_mul(self.op("Mul", [x, self.const_add(e, 1.0)]),
                              0.5)


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
    t = g.op("Add", [t, g.init("pos", np32(mod.pos_emb))])
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
        k1 = np32(mod.conv1.weight)                # (8,C,1,1)
        k2 = np32(mod.conv2.weight)                # (C,8,1,1)

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
        y = g.conv(x, np32(mod.m[i].weight), np32(mod.m[i].bias),
                   pads=(0, 0, 0, 0))
        # NCHW (B, na*no, ny, nx) -> (B, na, no, ny, nx) -> (B,na,ny,nx,no)
        y = g.reshape(y, (0, na, no, ny, nx))
        y = g.transpose(y, (0, 1, 3, 4, 2))
        z = g.op("Sigmoid", [y])
        s = float(strides[i])
        grid, anchor = detect_grid(anchors[i], na, ny, nx)
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
    two = is_two_stream(spec)
    g = _Emitter()

    x = "rgb" if two else "images"
    inputs = [ValueInfo(x, FLOAT, (batch, 3, img, img))]
    if two:
        inputs.append(ValueInfo("ir", FLOAT, (batch, 3, img, img)))
    if use_cem:
        x = emit_cem(g, x, model.Enhance, 3)

    def gpt(inp, mod, rl, in_hw):
        h, w = in_hw[0]
        return list(_emit_gpt(g, inp[0], inp[1], mod, rl.args[0],
                              spec.fusion_layers, h, w,
                              gated=rl.name != "GPT"))

    def detect(inp, mod, rl, in_hw):
        return _emit_detect(g, list(inp), mod, rl.args[0], rl.args[1],
                            spec.strides, list(in_hw))
    walk(spec, model, rows(g, gpt, detect), x, "ir" if two else None, img,
         g.what)
    na = spec.na
    n_pred = sum(na * (img // s) ** 2 for s in spec.strides)
    g.nodes[-1].outputs[-1] = "pred"  # the last node; nothing consumes it
    graph = Graph("mmidet", g.nodes, inputs,
                  [ValueInfo("pred", FLOAT, (batch, n_pred, spec.nc + 5))],
                  g.inits)
    out = Model(graph, doc=f"mmidet_tpu_torch deploy export img={img}")
    out.save(path)
    return out
