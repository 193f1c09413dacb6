"""YOLOv5-family building blocks in PyTorch (NCHW inside the modules).

Counterpart of ``mmidet_tpu/nn/layers.py`` for the modules the two-stream
deploy path runs: ``ConvBnAct``, ``Focus``, ``Bottleneck``, ``C3`` and
``SPP`` (reference ``models/common.py:96-748``).  Attribute names follow the
reference torch modules (``conv``/``bn``, ``cv1``..``cv3``, ``m``), so the
state-dict keys are the reference's ``model.{i}.cv1.conv.weight`` and the
JAX variables bridge onto them one to one (``mmidet_tpu_torch.bridge``).

``fused=True`` is the deploy form: the conv carries a bias and there is no
BatchNorm (``mmidet_tpu_torch.nn.fuse.fold_batchnorm`` turns an unfused
module into it).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

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


def batchnorm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation. Ref: common.py:108."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None,
                 g: int = 1, act: str | None = "silu", fused: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=fused)
        self.bn = None if fused else batchnorm(c2)
        self.act = act_fn(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class Focus(nn.Module):
    """Space-to-depth (2x2 pixel de-interleave -> 4C) + Conv.
    Ref: common.py:696.  The channel order is the reference's
    ``[x[::2,::2], x[1::2,::2], x[::2,1::2], x[1::2,1::2]]``, so the conv
    weight is the JAX ``conv_kernel_s2d`` in OIHW."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: str | None = "silu", fused: bool = False):
        super().__init__()
        self.conv = ConvBnAct(4 * c1, c2, k, s, act=act, fused=fused)

    def forward(self, x):
        return self.conv(torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                                    x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]],
                                   1))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with optional residual. Ref: common.py:602."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs. Ref: common.py:637."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, fused=fused)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, g, e=1.0,
                                            fused=fused) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling. Ref: common.py:681.  The stride-1 max pools
    pad with -inf (torch ``MaxPool2d``), so edges are maxima of real
    pixels, as ``_max_pool_same`` in the JAX package."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 fused: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_ * (len(k) + 1), c2, 1, 1, fused=fused)
        self.k = tuple(k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat(
            [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))
