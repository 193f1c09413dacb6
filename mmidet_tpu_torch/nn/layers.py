"""YOLOv5-family building blocks in PyTorch (NCHW inside the modules).

Counterpart of ``mmidet_tpu/nn/layers.py``: ``ConvBnAct``, ``DWConv``,
``Focus``, ``Bottleneck``, ``C3``, ``C3TR`` (with ``VitTransformerBlock``
and ``VitTransformerLayer``), ``BottleneckCSP``, ``SPP``, ``SPPF``,
``contract``/``expand``, ``Classify`` (reference ``models/common.py:96-748,
1131-1144``), ``CrossConv``, ``GhostConv``, ``GhostBottleneck``,
``MixConv2d`` and ``Sum`` (``models/experimental.py``), with the JAX
package's train-mode BatchNorm (``BatchNorm2d``).  Attribute names follow
the reference torch modules (``conv``/``bn``, ``cv1``..``cv4``, ``m``), or
the JAX package's scope names where the reference has none, so the
state-dict keys are the reference's ``model.{i}.cv1.conv.weight`` and the
JAX variables bridge onto them one to one (``mmidet_tpu_torch.bridge``).
The attention of ``VitTransformerLayer`` is four ``nn.Linear`` (``ma.query``,
``ma.key``, ``ma.value``, ``ma.out``), as flax's
``MultiHeadDotProductAttention`` holds it.

``fused=True`` is the deploy form: the conv carries a bias and there is no
BatchNorm (``mmidet_tpu_torch.nn.fuse.fold_batchnorm`` turns an unfused
module into it).

``quant=True`` is the s8-storage deploy form (``mmidet_tpu_torch.nn.quant``):
a fused ``ConvBnAct`` in eval mode returns a ``QTensor`` quantized with its
``out_scale`` buffer, and every module here dequantizes what it takes in
(``Bottleneck``'s residual and ``C3``'s concat both operands, ``SPP`` and
``SPPF`` after ``cv1``, before the pools).  ``DWConv``, ``Focus``,
``Bottleneck``, ``C3``, ``SPP`` and ``SPPF`` take the flag, the JAX
package's quantizable set; train mode and unfused modules ignore it.

BatchNorms without a single conv partner (``BottleneckCSP``'s ``bn`` over
its concat, ``MixConv2d``'s) and ``CrossConv``'s, which the JAX package
names ``cv1_bn``/``cv2_bn`` and so never folds, stay BatchNorms after
``fold_batchnorm``, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.nn.quant import QTensor, dequantize, quantize
from mmidet_tpu_torch.parallel import comm

# YOLOv5's BatchNorm settings (reference utils/torch_utils.py
# initialize_weights): eps 1e-3, torch momentum 0.03
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k: int | Sequence[int], p=None):
    """'same' padding for odd kernels. Ref: common.py:96."""
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


def act_fn(name: str | None) -> Callable[[torch.Tensor], torch.Tensor]:
    table = {
        "silu": F.silu,
        "relu": F.relu,
        "relu6": F.relu6,
        "leaky0.1": lambda x: F.leaky_relu(x, 0.1),
        "hardswish": F.hardswish,
        "mish": F.mish,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "identity": lambda x: x,
        None: lambda x: x,
    }
    return table[name]


class BatchNorm2d(nn.BatchNorm2d):
    """YOLOv5's BatchNorm (eps 1e-3, momentum 0.03) with the JAX package's
    train-mode rule, which is flax's: normalise by the batch's biased
    variance, and update ``running_mean`` and ``running_var`` with
    momentum 0.03 (flax 0.97) from the batch mean and the **biased** batch
    variance.  ``torch.nn.BatchNorm2d`` updates ``running_var`` with the
    unbiased variance (n / (n - 1) larger, PARITY.md:257-266), so train
    mode runs the native kernel without running buffers and the update is
    done here from the batch statistics that kernel returns (mean and
    inverse std, f32 under bf16 autocast).  Eval mode, the state-dict
    names (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``) and ``fold_batchnorm`` are torch's.

    ``update_stats = False`` normalises by the batch as above and leaves
    the running buffers as they are: the train step's recomputation of the
    forward under ``remat`` sets it, so that a step updates them once.

    Inside a data-parallel step (``parallel.comm.data_group``) the batch
    statistics are the global batch's, as under the JAX package's GSPMD:
    the sum, the sum of squares and the count of every rank's rows are
    all-reduced over the data group (with autograd), then the sum of
    squares about that mean (in f32, f64 for an f64 input), and the
    running buffers take the same update from them."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        g = comm.active()
        if g is not None:
            y, mean, var = self._global_batch(x, g.group)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        if not self.update_stats:
            return y
        with torch.no_grad():
            if var is None:
                var = invstd.pow(-2) - self.eps
            m = self.momentum  # flax: 0.97 * running + 0.03 * batch
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch(self, x, group):
        """(y, mean, biased var) over the rows of every rank in ``group``."""
        xf = x if x.dtype == torch.float64 else x.float()
        c = xf.shape[1]
        s, n = comm.global_sum([xf.sum((0, 2, 3)),
                                xf.new_full((1,), xf.numel() // c)], group)
        mean = s / n
        d = xf - mean[None, :, None, None]
        var, = comm.global_sum([(d * d).sum((0, 2, 3))], group)
        var = var / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = d * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


def batchnorm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation. Ref: common.py:108.

    With ``quant`` the module holds an ``out_scale`` buffer (f32, see
    ``_apply``) and, fused and in eval mode, returns its activation as a
    ``QTensor``."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None,
                 g: int = 1, act: str | None = "silu", fused: bool = False,
                 quant: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=fused)
        self.bn = None if fused else batchnorm(c2)
        self.act = act_fn(act)
        self.quant = False
        if quant:
            self.set_quant(1.0)

    def set_quant(self, scale) -> None:
        """Quantize this module's output with ``scale`` from now on."""
        self.quant = True
        self.register_buffer("out_scale", torch.as_tensor(
            scale, dtype=torch.float32,
            device=self.conv.weight.device).reshape(()).clone())

    def _apply(self, fn, recurse=True):
        # the scale stays f32 when the model is cast (``.to(bfloat16)``),
        # as the JAX package's quant collection does: only its device moves
        s = self._buffers.get("out_scale")
        out = super()._apply(fn, recurse)
        if s is not None:
            self._buffers["out_scale"] = s.to(
                self._buffers["out_scale"].device)
        return out

    def forward(self, x):
        if isinstance(x, QTensor):
            x = dequantize(x, self.conv.weight.dtype)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        x = self.act(x)
        if self.quant and self.bn is None and not self.training:
            return quantize(x, self.out_scale)
        return x


class Focus(nn.Module):
    """Space-to-depth (2x2 pixel de-interleave -> 4C) + Conv.
    Ref: common.py:696.  The channel order is the reference's
    ``[x[::2,::2], x[1::2,::2], x[::2,1::2], x[1::2,1::2]]``, so the conv
    weight is the JAX ``conv_kernel_s2d`` in OIHW."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: str | None = "silu", fused: bool = False,
                 quant: bool = False):
        super().__init__()
        self.conv = ConvBnAct(4 * c1, c2, k, s, act=act, fused=fused,
                              quant=quant)

    def forward(self, x):
        x = dequantize(x, self.conv.conv.weight.dtype)
        return self.conv(torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                                    x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]],
                                   1))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with optional residual. Ref: common.py:602."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False, quant: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g, fused=fused, quant=quant)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if not self.add:
            return y
        dt = self.cv2.conv.weight.dtype
        return dequantize(x, dt) + dequantize(y, dt)


class C3(nn.Module):
    """CSP bottleneck with 3 convs. Ref: common.py:637."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, fused: bool = False,
                 quant: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c1, c_, 1, 1, fused=fused, quant=quant)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, fused=fused, quant=quant)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, g, e=1.0,
                                            fused=fused, quant=quant)
                                 for _ in range(n)])

    def forward(self, x):
        dt = self.cv3.conv.weight.dtype
        return self.cv3(torch.cat([dequantize(self.m(self.cv1(x)), dt),
                                   dequantize(self.cv2(x), dt)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling. Ref: common.py:681.  The stride-1 max pools
    pad with -inf (torch ``MaxPool2d``), so edges are maxima of real
    pixels, as ``_max_pool_same`` in the JAX package."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 fused: bool = False, quant: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c_ * (len(k) + 1), c2, 1, 1, fused=fused,
                             quant=quant)
        self.k = tuple(k)

    def forward(self, x):
        x = dequantize(self.cv1(x), self.cv1.conv.weight.dtype)
        return self.cv2(torch.cat(
            [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class DWConv(nn.Module):
    """Depthwise conv (groups = gcd(c1, c2)). Ref: common.py:103; the
    JAX package's scope ``conv`` around a ``ConvBnAct``."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1,
                 act: str | None = "silu", fused: bool = False,
                 quant: bool = False):
        super().__init__()
        self.conv = ConvBnAct(c1, c2, k, s, g=math.gcd(c1, c2), act=act,
                              fused=fused, quant=quant)

    def forward(self, x):
        return self.conv(x)


class VitTransformerLayer(nn.Module):
    """LayerNorm-free ViT layer (q/k/v + multi-head attention + 2-linear
    MLP) on (B, L, c) tokens.  Ref: common.py:555-569 (TransformerLayer).
    ``q``/``k``/``v`` feed the attention's own projections (``ma``), as in
    the reference and the JAX package; the attention scales the queries by
    1/sqrt(head_dim), flax's default."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.Module()
        for name in ("query", "key", "value", "out"):
            setattr(self.ma, name, nn.Linear(c, c))
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def _attention(self, q, k, v):
        b, n, c = q.shape
        heads = [getattr(self.ma, name)(t).view(
            b, n, self.num_heads, c // self.num_heads).transpose(1, 2)
            for name, t in (("query", q), ("key", k), ("value", v))]
        y = F.scaled_dot_product_attention(*heads)
        return self.ma.out(y.transpose(1, 2).reshape(b, n, c))

    def forward(self, x):
        x = self._attention(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class VitTransformerBlock(nn.Module):
    """ViT block over the flattened spatial tokens with a learned linear
    position term.  Ref: common.py:572-599 (TransformerBlock)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int,
                 fused: bool = False):
        super().__init__()
        self.conv = ConvBnAct(c1, c2, fused=fused) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*[VitTransformerLayer(c2, num_heads)
                                  for _ in range(num_layers)])

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)
        p = self.tr(p + self.linear(p))
        return p.transpose(1, 2).reshape(b, c, h, w)


class C3TR(nn.Module):
    """C3 with a ViT transformer block as the inner stack (4 heads).
    Ref: common.py:654."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, fused=fused)
        self.m = VitTransformerBlock(c_, c_, 4, n, fused=fused)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class BottleneckCSP(nn.Module):
    """Original CSP bottleneck. Ref: common.py:616.  ``cv2``/``cv3`` are
    bias-free convs whose outputs share one BatchNorm (``bn``) over their
    concat, which stays a BatchNorm in the deploy form."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1, fused=fused)
        self.bn = batchnorm(2 * c_)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, g, e=1.0,
                                            fused=fused)
                                 for _ in range(n)])

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        y = self.bn(torch.cat([y1, self.cv2(x)], 1))
        return self.cv4(F.leaky_relu(y, 0.1))


class SPPF(nn.Module):
    """SPP-Fast: three chained 5x5 pools, equal to SPP(5, 9, 13).
    Ref: common.py:662."""

    def __init__(self, c1: int, c2: int, k: int = 5, fused: bool = False,
                 quant: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1, 1, fused=fused, quant=quant)
        self.k = k

    def forward(self, x):
        ys = [dequantize(self.cv1(x), self.cv1.conv.weight.dtype)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


def contract(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Space into channels, (B, C, H, W) -> (B, C*s*s, H/s, W/s), channel
    index (sh * s + sw) * C + c.  Ref: common.py:712."""
    b, c, h, w = x.shape
    s = gain
    x = x.view(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * s * s, h // s, w // s)


def expand(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Channels into space, the inverse of ``contract``.
    Ref: common.py:726."""
    b, c, h, w = x.shape
    s = gain
    x = x.view(b, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // s ** 2, h * s, w * s)


class Classify(nn.Module):
    """Global-pool classification head: mean over H, W of each input,
    concatenated, then a conv with bias.  Ref: common.py:1131."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k))

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        z = torch.cat([y.mean((2, 3), keepdim=True) for y in xs], 1)
        return self.conv(z).flatten(1)


class _ConvBnKept(ConvBnAct):
    """A ``ConvBnAct`` whose BatchNorm ``fold_batchnorm`` leaves alone: the
    JAX package names CrossConv's pairs ``cv1_conv``/``cv1_bn``, which its
    fold does not pair."""

    keep_bn = True


class CrossConv(nn.Module):
    """1xk then kx1 cross conv, exactly two convs. Ref: experimental.py:11.
    Takes no ``fused``: its BatchNorms stay (module docstring)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 g: int = 1, e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        p = autopad(k)
        self.cv1 = _ConvBnKept(c1, c_, (1, k), (1, s), (0, p))
        self.cv2 = _ConvBnKept(c_, c2, (k, 1), (s, 1), (p, 0), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class GhostConv(nn.Module):
    """Ghost convolution. Ref: experimental.py:61."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1,
                 act: str | None = "silu", fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, act=act, fused=fused)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, g=c_, act=act, fused=fused)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck. Ref: experimental.py:71; the JAX package's scope
    names (``conv1``, ``dw``, ``conv2``, ``sc_dw``, ``sc_pw``)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.stride = s
        self.conv1 = GhostConv(c1, c_, 1, 1, fused=fused)
        self.dw = DWConv(c_, c_, k, s, act=None, fused=fused) \
            if s == 2 else None
        self.conv2 = GhostConv(c_, c2, 1, 1, act=None, fused=fused)
        if s == 2:
            self.sc_dw = DWConv(c1, c1, k, s, act=None, fused=fused)
            self.sc_pw = ConvBnAct(c1, c2, 1, 1, act=None, fused=fused)
        elif c1 != c2:
            raise ValueError("GhostBottleneck stride-1 requires c1 == c2")

    def forward(self, x):
        y = self.conv1(x)
        if self.dw is not None:
            y = self.dw(y)
        y = self.conv2(y)
        sc = self.sc_pw(self.sc_dw(x)) if self.stride == 2 else x
        return y + sc


class MixConv2d(nn.Module):
    """Mixed-kernel-size conv with the channels split equally, then
    ``x + leaky_relu(bn(concat))``.  Ref: experimental.py:84.  Takes no
    ``fused``: its BatchNorm stays (module docstring)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3),
                 s: int = 1):
        super().__init__()
        groups = len(k)
        idx = np.linspace(0, groups - 1e-6, c2).astype(int)
        ch = [int((idx == g).sum()) for g in range(groups)]
        self.m = nn.ModuleList(nn.Conv2d(c1, c, kk, s, autopad(kk),
                                         bias=False)
                               for kk, c in zip(k, ch))
        self.bn = batchnorm(c2)

    def forward(self, x):
        y = self.bn(torch.cat([m(x) for m in self.m], 1))
        return x + F.leaky_relu(y, 0.1)


class Sum(nn.Module):
    """Sum of the inputs, optionally weighted by 2 * sigmoid(w), w starting
    at -arange(1, n) / 2.  Ref: experimental.py:45."""

    def __init__(self, n: int, weighted: bool = False):
        super().__init__()
        self.n = n
        self.w = nn.Parameter(-torch.arange(1.0, n) / 2) if weighted \
            else None

    def forward(self, xs):
        y = xs[0]
        if self.w is None:
            for x in xs[1:]:
                y = y + x
            return y
        w = torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + xs[i + 1] * w[i].to(xs[0].dtype)
        return y
