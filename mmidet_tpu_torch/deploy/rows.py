"""The row walk and the row emitters that the port's two graph emitters
share: ``onnx_export`` (NCHW, ONNX) and ``tf_graph`` (NHWC, SavedModel and
TFLite).

``walk`` runs through ``resolve(spec)`` beside the modules of a BN-folded
detector, feeds each row's handler the values its ``from`` indices name
(the previous row, the second input, or a saved row), keeps the spatial
size of every value (by the rows' own rule, ``_out_hw``, or read off the
emitted value by the caller's ``hw_of``), saves the rows that later rows
read, and returns what the Detect row gave.  ``rows`` is the handler
table: the rows whose ops are the same in both layouts are emitted here,
through the emitter's ``conv``, ``act``, ``add``, ``concat``,
``max_pool`` and ``upsample`` (an ONNX node or a TF op each, in the
emitter's layout); the GPT rows and Detect, whose dataflow differs by
layout, come from the caller, and ``tf_graph`` adds the rows only the
TF legs take.
``detect_grid`` gives Detect's grid and anchors as the decode adds them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from mmidet_tpu_torch.models.spec import SECOND_INPUT, ModelSpec, resolve
from mmidet_tpu_torch.nn.cem import edge_filter_bank
from mmidet_tpu_torch.nn.layers import autopad

GPT_ROWS = ("GPT", "GPT1", "GPT1_fourier")
UPSAMPLE_ROWS = ("Upsample", "nn.Upsample")


def upsample_scale(rl) -> int:
    return int(rl.args[1]) if len(rl.args) >= 2 and rl.args[1] else 2


def upsample_mode(rl) -> str:
    return rl.args[2] if len(rl.args) >= 3 and isinstance(
        rl.args[2], str) else "nearest"


def _out_hw(rl, in_hw):
    """The spatial size of a row's value from that of its inputs."""
    m = rl.name
    if m == "Conv":
        stride = rl.args[2] if len(rl.args) > 2 else 1
        return (in_hw[0] // stride, in_hw[1] // stride)
    if m == "Focus":
        return (in_hw[0] // 2, in_hw[1] // 2)
    if m in ("C3", "Bottleneck", "SPP", "SPPF"):
        return in_hw
    if m in UPSAMPLE_ROWS:
        scale = upsample_scale(rl)
        return (in_hw[0] * scale, in_hw[1] * scale)
    return in_hw[0]    # Concat, Add, Add2, the GPT rows, Detect


def walk(spec: ModelSpec, model, rows: dict[str, Callable], x, x2,
         img: int, what: str, hw_of: Callable | None = None):
    """Walk ``spec``'s rows with ``model.model``'s modules.  ``rows`` maps
    a row name to ``handler(inp, mod, rl, in_hw) -> value``, where ``inp``
    is one value or a list of them (a tuple ``from``) and ``in_hw`` their
    (ny, nx) sizes alike.  ``x`` is the first input (after the CEM, if
    any), ``x2`` the second or None.  ``hw_of(value)``, where given,
    gives a row's (ny, nx) from the value its handler returned.  Returns
    the Detect row's value; a row with no handler raises ``ValueError``
    naming it."""
    resolved, save = resolve(spec)
    hw = {}          # layer index -> (ny, nx) spatial dims
    cur_hw = (img, img)
    hw2 = (img, img)
    y: dict[int, object] = {}
    pred = None
    for rl, mod in zip(resolved, model.model):
        def get(j):
            if j == -1:
                return x
            if j == SECOND_INPUT:
                return x2
            return y[j]

        def size(j):
            if j == -1:
                return cur_hw
            if j == SECOND_INPUT:
                return hw2
            return hw.get(j, cur_hw)

        if isinstance(rl.f, tuple):
            inp = [get(j) for j in rl.f]
            in_hw = [size(j) for j in rl.f]
        else:
            inp, in_hw = get(rl.f), size(rl.f)
        handler = rows.get(rl.name)
        if handler is None:
            raise ValueError(f"{what}: unhandled module {rl.name!r} "
                             f"(layer {rl.index})")
        x = handler(inp, mod, rl, in_hw)
        cur_hw = hw_of(x) if hw_of else _out_hw(rl, in_hw)
        if rl.name == "Detect":
            pred = x
        if rl.index in save:
            y[rl.index] = x
            hw[rl.index] = cur_hw
    if pred is None:
        raise ValueError("spec has no Detect layer")
    return pred


def detect_grid(anchors_i, na: int, ny: int, nx: int):
    """One level's decode constants: the (1, 1, ny, nx, 2) cell grid
    (x, y) and the (1, na, 1, 1, 2) anchors in pixels."""
    gy, gx = np.meshgrid(np.arange(ny, dtype=np.float32),
                         np.arange(nx, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)[None, None]            # (1,1,ny,nx,2)
    anchor = np.asarray(anchors_i, np.float32).reshape(1, na, 1, 1, 2)
    return grid, anchor


# ----------------------------------------------------------- row emitters

def np32(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def conv_of(g, mod) -> tuple[np.ndarray, np.ndarray]:
    """A folded ``ConvBnAct``'s OIHW kernel and bias."""
    if mod.bn is not None or mod.conv.bias is None:
        raise ValueError(f"{g.what} needs the BN-folded model "
                         "(fold_batchnorm)")
    return np32(mod.conv.weight), np32(mod.conv.bias)


def emit_convbnact(g, x, mod, args):
    """Folded ``ConvBnAct``; args = (c2, k=1, s=1, pad=None, groups=1,
    act='silu')."""
    k = args[1] if len(args) > 1 else 1
    s = args[2] if len(args) > 2 else 1
    pad = args[3] if len(args) > 3 else None
    groups = args[4] if len(args) > 4 else 1
    act = args[5] if len(args) > 5 else "silu"
    pp = autopad(k, pad)
    pp = (pp, pp) if isinstance(pp, int) else tuple(pp)
    w, b = conv_of(g, mod)
    y = g.conv(x, w, b, stride=s, pads=(pp[0], pp[1], pp[0], pp[1]),
               groups=groups)
    return g.act(y, act)


def emit_focus(g, x, mod, args):
    """Folded Focus: its space-to-depth conv (the four strided slices in
    YOLOv5's order, concatenated) rearranged into one (2k, 2k) stride-2
    conv on the image."""
    w, b = conv_of(g, mod.conv)
    kern = w.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
    k = kern.shape[0]
    c1 = kern.shape[2] // 4
    co = kern.shape[3]
    act = args[2] if len(args) > 2 else "silu"
    p_ = autopad(k)
    w = kern.reshape(k, k, 2, 2, c1, co)
    big = np.zeros((2 * k, 2 * k, c1, co), np.float32)
    for rg in range(2):
        for sg in range(2):
            big[rg::2, sg::2] = w[:, :, sg, rg]
    y = g.conv(x, big.transpose(3, 2, 0, 1), b, stride=2,
               pads=(2 * p_, 2 * p_, 2 * p_, 2 * p_))
    return g.act(y, "silu" if not isinstance(act, str) else act)


def emit_bottleneck(g, x, mod, features, shortcut, c_in):
    y = emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    y = emit_convbnact(g, y, mod.cv2, (None, 3, 1))
    if shortcut and c_in == features:
        return g.add(x, y)
    return y


def emit_c3(g, x, mod, args):
    c2 = args[0]
    n = args[1] if len(args) > 1 else 1
    shortcut = args[2] if len(args) > 2 else True
    c_ = int(c2 * 0.5)
    y1 = emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    for i in range(n):
        y1 = emit_bottleneck(g, y1, mod.m[i], c_, shortcut, c_)
    y2 = emit_convbnact(g, x, mod.cv2, (None, 1, 1))
    return emit_convbnact(g, g.concat([y1, y2]), mod.cv3, (None, 1, 1))


def emit_spp(g, x, mod, kernels):
    x = emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    ys = [x] + [g.max_pool(x, k) for k in kernels]
    return emit_convbnact(g, g.concat(ys), mod.cv2, (None, 1, 1))


def emit_sppf(g, x, mod, k):
    x = emit_convbnact(g, x, mod.cv1, (None, 1, 1))
    y1 = g.max_pool(x, k)
    y2 = g.max_pool(y1, k)
    y3 = g.max_pool(y2, k)
    return emit_convbnact(g, g.concat([x, y1, y2, y3]), mod.cv2,
                          (None, 1, 1))


def emit_cem(g, x, mod, c):
    """Folded ContourEnhance: conv2 + leaky, the edge bank (ONE full
    (8c, 8c) constant conv: output channel o carries kernel o % 8 on every
    input channel, scaled by its factor), residual, conv3 + leaky,
    residual."""
    if mod.bn2 is not None or mod.bn3 is not None:
        raise ValueError(f"{g.what} needs the BN-folded model "
                         "(fold_batchnorm)")
    y = g.conv(x, np32(mod.conv2.weight), np32(mod.conv2.bias),
               stride=1, pads=(1, 1, 1, 1))
    y = g.act(y, "leaky0.1")
    c8 = 8 * c
    bank = edge_filter_bank(c8, c8, 3)           # (3,3,in=8c,out=8c) HWIO
    factor = np32(mod.sobel.sobel_factor).reshape(-1)
    e = g.conv(y, np.transpose(bank * factor[None, None, None, :],
                               (3, 2, 0, 1)),
               np32(mod.sobel.bias), stride=1, pads=(1, 1, 1, 1))
    y = g.add(y, e)
    y = g.conv(y, np32(mod.conv3.weight), np32(mod.conv3.bias),
               stride=1, pads=(1, 1, 1, 1))
    y = g.act(y, "leaky0.1")
    return g.add(y, x)


def _bottleneck_row(g, inp, mod, rl):
    sc = rl.args[1] if len(rl.args) > 1 else True
    # n > 1: sequential repeats (hub yolov3), model.{i}.{r}
    x = inp
    for copy in (list(mod) if rl.n > 1 else [mod]):
        x = emit_bottleneck(g, x, copy, rl.args[0], sc, rl.args[0])
    return x


def _upsample_row(g, inp, rl):
    if upsample_mode(rl) != "nearest":
        raise ValueError(f"{g.what}: only nearest upsample")
    return g.upsample(inp, upsample_scale(rl))


def rows(g, gpt: Callable, detect: Callable) -> dict[str, Callable]:
    """``walk``'s handler table over the emitter ``g``: ``gpt`` and
    ``detect`` handle the GPT rows and Detect."""
    table = {
        "Conv": lambda inp, mod, rl, hw: emit_convbnact(g, inp, mod,
                                                        rl.args),
        "Focus": lambda inp, mod, rl, hw: emit_focus(g, inp, mod, rl.args),
        "C3": lambda inp, mod, rl, hw: emit_c3(g, inp, mod, rl.args),
        "Bottleneck": lambda inp, mod, rl, hw: _bottleneck_row(g, inp, mod,
                                                               rl),
        "SPP": lambda inp, mod, rl, hw: emit_spp(
            g, inp, mod, rl.args[1] if len(rl.args) > 1 else (5, 9, 13)),
        "SPPF": lambda inp, mod, rl, hw: emit_sppf(
            g, inp, mod, rl.args[1] if len(rl.args) > 1 else 5),
        "Concat": lambda inp, mod, rl, hw: g.concat(list(inp)),
        "Add": lambda inp, mod, rl, hw: g.add(inp[0], inp[1]),
        "Add2": lambda inp, mod, rl, hw: g.add(inp[0],
                                               inp[1][rl.args[0]]),
        "Detect": detect,
    }
    table.update({m: lambda inp, mod, rl, hw: _upsample_row(g, inp, rl)
                  for m in UPSAMPLE_ROWS})
    table.update({m: gpt for m in GPT_ROWS})
    return table
