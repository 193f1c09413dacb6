"""YOLOv5-family building blocks in PyTorch (NCHW inside the modules).

Counterpart of ``mmidet_tpu/nn/layers.py`` for the modules the two-stream
models run: ``ConvBnAct``, ``Focus``, ``Bottleneck``, ``C3`` and ``SPP``
(reference ``models/common.py:96-748``), with the JAX package's train-mode
BatchNorm (``BatchNorm2d``).  Attribute names follow the
reference torch modules (``conv``/``bn``, ``cv1``..``cv3``, ``m``), so the
state-dict keys are the reference's ``model.{i}.cv1.conv.weight`` and the
JAX variables bridge onto them one to one (``mmidet_tpu_torch.bridge``).

``fused=True`` is the deploy form: the conv carries a bias and there is no
BatchNorm (``mmidet_tpu_torch.nn.fuse.fold_batchnorm`` turns an unfused
module into it).

``quant=True`` is the s8-storage deploy form (``mmidet_tpu_torch.nn.quant``):
a fused ``ConvBnAct`` in eval mode returns a ``QTensor`` quantized with its
``out_scale`` buffer, and every module here dequantizes what it takes in
(``Bottleneck``'s residual and ``C3``'s concat both operands, ``SPP`` after
``cv1``, before the pools).  Train mode and unfused modules ignore the
flag, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.nn.quant import QTensor, dequantize, quantize

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
    forward under ``remat`` sets it, so that a step updates them once."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            m = self.momentum  # flax: 0.97 * running + 0.03 * batch
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(
                m * (invstd.pow(-2) - self.eps))
            self.num_batches_tracked.add_(1)
        return y


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
