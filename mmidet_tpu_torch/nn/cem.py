"""Contour Enhancement Module (CEM): a fixed directional edge-filter bank
with a trainable per-output-channel scale, inside an expand/reduce conv
residual.  Counterpart of ``mmidet_tpu/nn/cem.py``; reference
``AdaptiveModule3`` (common.py:751-803) and ``EnhanceConv2d``
(common.py:806-911), applied to the RGB input only.

The 8-direction bank cycles Sobel-H, Sobel-V, two diagonals (the reference's
two diagonal cases are identical — a quirk kept here), +/-Laplacian,
Prewitt-H and Prewitt-V, and every input channel of an output channel
carries the same kernel.  So ``conv(x, bank * factor)[o]`` equals
``factor[o] * conv(sum_i x_i, bank8[o % 8])``: one channel sum, one
1->8-channel conv with the 8 distinct kernels and a tiled scale.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.nn.layers import batchnorm


@functools.lru_cache(maxsize=None)
def edge_filter_bank(out_channels: int, in_channels: int,
                     k: int = 3) -> np.ndarray:
    """HWIO (k, k, in, out) constant bank, the JAX package's layout.
    Ref: common.py:837-882."""
    assert k % 2 == 1 and out_channels % 8 == 0
    mid = k // 2
    w = np.zeros((out_channels, k, k), np.float32)  # per-output 2D kernel
    for idx in range(out_channels):
        r = idx % 8
        kern = w[idx]
        if r == 0:  # Sobel horizontal
            kern[0, :] = -1
            kern[0, mid] = -2
            kern[-1, :] = 1
            kern[-1, mid] = 2
        elif r == 1:  # Sobel vertical
            kern[:, 0] = -1
            kern[mid, 0] = -2
            kern[:, -1] = 1
            kern[mid, -1] = 2
        elif r in (2, 3):  # diagonal (both cases identical in the reference)
            kern[0, 0] = -2
            for i in range(mid + 1):
                kern[mid - i, i] = -1
                kern[k - 1 - i, mid + i] = 1
            kern[-1, -1] = 2
        elif r == 4:  # Laplacian
            kern[0, mid] = 1
            kern[mid, :] = 1
            kern[mid, mid] = -4
            kern[-1, mid] = 1
        elif r == 5:  # negative Laplacian
            kern[0, mid] = 1
            kern[mid, :] = 1
            kern[mid, mid] = 4
            kern[-1, mid] = 1
        elif r == 6:  # Prewitt horizontal
            kern[0, :] = -1
            kern[-1, :] = 1
        else:  # Prewitt vertical
            kern[:, 0] = -1
            kern[:, -1] = 1
    # same kernel on every input channel: (out,k,k) -> (k,k,in,out)
    hwio = np.broadcast_to(w.transpose(1, 2, 0)[:, :, None, :],
                           (k, k, in_channels, out_channels))
    return np.ascontiguousarray(hwio)


class EnhanceConv(nn.Module):
    """Frozen edge bank x trainable per-channel scale + bias.
    Ref: EnhanceConv2d, common.py:806-911.  ``sobel_factor`` keeps the
    reference's ``(out, 1, 1, 1)`` shape."""

    def __init__(self, c: int, k: int = 3):
        super().__init__()
        self.sobel_factor = nn.Parameter(torch.ones(c, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(c))
        bank8 = edge_filter_bank(8, 1, k)[:, :, 0, :].transpose(2, 0, 1)
        self.register_buffer("bank8", torch.from_numpy(
            np.ascontiguousarray(bank8))[:, None], persistent=False)

    def forward(self, x):
        xsum = x.sum(1, keepdim=True)
        g = F.conv2d(xsum, self.bank8.to(x.dtype),
                     padding=self.bank8.shape[-1] // 2)
        c = self.bias.shape[0]
        y = g.repeat(1, c // 8, 1, 1)
        return (y * self.sobel_factor.view(1, c, 1, 1).to(x.dtype)
                + self.bias.view(1, c, 1, 1).to(x.dtype))


class ContourEnhance(nn.Module):
    """CEM: expand x8 -> edge bank -> add -> reduce -> residual.
    Ref: AdaptiveModule3, common.py:751-803 (conv/bn/leaky-relu 0.1).
    ``fused=True``: BN folded into conv weight and bias (deploy form)."""

    def __init__(self, c: int = 3, fused: bool = False):
        super().__init__()
        self.conv2 = nn.Conv2d(c, c * 8, 3, 1, 1, bias=fused)
        self.bn2 = None if fused else batchnorm(c * 8)
        self.sobel = EnhanceConv(c * 8)
        self.conv3 = nn.Conv2d(c * 8, c, 3, 1, 1, bias=fused)
        self.bn3 = None if fused else batchnorm(c)

    def forward(self, x):
        y = self.conv2(x)
        if self.bn2 is not None:
            y = self.bn2(y)
        y = F.leaky_relu(y, 0.1)
        y = self.conv3(y + self.sobel(y))
        if self.bn3 is not None:
            y = self.bn3(y)
        return F.leaky_relu(y, 0.1) + x
