"""Parametric activation modules, in PyTorch (NCHW).

Counterpart of ``mmidet_tpu/nn/activations.py``; reference
``utils/activations.py``.  The stateless activations live in
``nn.layers.act_fn``; these are the three with parameters:

  * ``FReLU``     -- max(x, BN(depthwise conv(x))) (activations.py:48-56);
  * ``AconC``     -- (p1-p2)x * sigmoid(beta (p1-p2)x) + p2 x with learnable
                     per-channel p1, p2, beta (activations.py:59-76);
  * ``MetaAconC`` -- AconC with beta = sigmoid(fc2(fc1(mean_hw(x)))), the
                     reference's variant without BN (activations.py:79-98).

Per-channel parameters are ``(C,)``, as the JAX package holds them.
"""

from __future__ import annotations

import torch
from torch import nn

from mmidet_tpu_torch.nn.layers import autopad, batchnorm


def _channels(p: torch.Tensor) -> torch.Tensor:
    return p.view(1, -1, 1, 1)


class FReLU(nn.Module):
    """max(x, BN(depthwise k x k conv(x))).  ``fold_batchnorm`` folds its
    ``conv``/``bn`` pair as the JAX package's fold does."""

    def __init__(self, c: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(c, c, k, 1, k // 2, groups=c, bias=False)
        self.bn = batchnorm(c)

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return torch.maximum(x, y)


class AconC(nn.Module):
    """dpx * sigmoid(beta * dpx) + p2 * x, dpx = (p1 - p2) * x."""

    def __init__(self, c: int):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(c))
        self.p2 = nn.Parameter(torch.randn(c))
        self.beta = nn.Parameter(torch.ones(c))

    def forward(self, x):
        dpx = _channels(self.p1 - self.p2) * x
        return dpx * torch.sigmoid(_channels(self.beta) * dpx) \
            + _channels(self.p2) * x


class MetaAconC(nn.Module):
    """AconC with beta generated from the channel means by two k x k convs
    (with bias) through a bottleneck of max(r, c // r) channels."""

    def __init__(self, c: int, k: int = 1, s: int = 1, r: int = 16):
        super().__init__()
        c2 = max(r, c // r)
        self.p1 = nn.Parameter(torch.randn(c))
        self.p2 = nn.Parameter(torch.randn(c))
        self.fc1 = nn.Conv2d(c, c2, k, s, autopad(k))
        self.fc2 = nn.Conv2d(c2, c, k, s, autopad(k))

    def forward(self, x):
        beta = torch.sigmoid(self.fc2(self.fc1(x.mean((2, 3), keepdim=True))))
        dpx = _channels(self.p1 - self.p2) * x
        return dpx * torch.sigmoid(beta * dpx) + _channels(self.p2) * x
