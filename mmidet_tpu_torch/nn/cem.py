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

from mmidet_tpu_torch import kernels
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


def _tail_reference(y, factor, bias_s, w3, b3):
    """The CEM tail as the unfused module computes it: edge bank -> add ->
    conv3 (+ bias), before the leaky ReLU and the residual.  NCHW; ``w3``
    OIHW.  It recomputes the border ring of ``tail_composed``."""
    bank8 = torch.from_numpy(np.ascontiguousarray(
        edge_filter_bank(8, 1, 3)[:, :, 0, :].transpose(2, 0, 1)))[:, None]
    g = F.conv2d(y.sum(1, keepdim=True), bank8.to(y), padding=1)
    c2 = y.shape[1]
    e = g.repeat(1, c2 // 8, 1, 1) * factor.view(1, c2, 1, 1) \
        + bias_s.view(1, c2, 1, 1)
    return F.conv2d(y + e, w3, b3, padding=1)


def compose_tail_kernel(factor, bias_s, w3, b3):
    """Collapse the linear CEM tail into ONE 5x5 conv kernel and a bias.

    Between the two leaky ReLUs the tail is linear in ``y``; with outer
    offset a (``w3``) and inner offset q (the bank), the bank leg
    contributes ``K5[a+q, j, o] = sum_m wf[a, m, o] * bank[q, m]`` for
    every input channel j (the bank acts on the channel sum), where
    ``wf[a, m, o] = sum_{j % 8 == m} w3[a, j, o] * factor[j]``; the direct
    leg puts ``w3`` at the 5x5 centre, and the constant ``bias_s`` leg
    folds into the bias (its interior value).  ``w3`` OIHW; returns
    (kernel (co, C2, 5, 5) OIHW, bias (co,)) in f32.  JAX
    ``compose_tail_kernel``."""
    co, c2 = w3.shape[0], w3.shape[1]
    bank8 = torch.from_numpy(
        np.asarray(edge_filter_bank(8, 1, 3))[:, :, 0, :]).to(w3.device)
    w3 = w3.float().permute(2, 3, 1, 0)                      # HWIO
    factor = factor.float()
    wf = (w3 * factor[None, None, :, None]).reshape(
        3, 3, c2 // 8, 8, co).sum(2)                         # (3, 3, 8, co)
    k5 = torch.zeros(5, 5, co, device=w3.device)
    for ai in range(3):
        for aj in range(3):
            k5[ai:ai + 3, aj:aj + 3] += torch.einsum(
                "qrm,mo->qro", bank8, wf[ai, aj])
    k = k5[:, :, None, :].expand(5, 5, c2, co).clone()
    k[1:4, 1:4] += w3
    b = b3.float() + torch.einsum("hwjo,j->o", w3, bias_s.float())
    return k.permute(3, 2, 0, 1), b


def tail_composed(y, factor, bias_s, w3, b3):
    """The CEM tail as ONE 5x5 conv, with its 1-px border ring recomputed
    exactly.  The composed kernel assumes the bank's products extend past
    the image border and ``bias_s`` at its interior value, both wrong on
    the outermost ring only; each border row and column is recomputed with
    the plain tail on a 3-wide strip, whose cut-edge padding error reaches
    only strip outputs that are dropped.  NCHW; ``w3`` OIHW.  JAX
    ``tail_composed``, opt-in there too (it measured slower on its
    accelerator at the CEM's 3 output channels)."""
    k, b = compose_tail_kernel(factor, bias_s, w3, b3)
    z = F.conv2d(y, k.to(y.dtype), b.to(y.dtype), padding=2)
    args = (factor.to(y.dtype), bias_s.to(y.dtype), w3.to(y.dtype),
            b3.to(y.dtype))
    z[:, :, :1] = _tail_reference(y[:, :, :3], *args)[:, :, :1]
    z[:, :, -1:] = _tail_reference(y[:, :, -3:], *args)[:, :, -1:]
    z[:, :, :, :1] = _tail_reference(y[:, :, :, :3], *args)[:, :, :, :1]
    z[:, :, :, -1:] = _tail_reference(y[:, :, :, -3:], *args)[:, :, :, -1:]
    return z


class ContourEnhance(nn.Module):
    """CEM: expand x8 -> edge bank -> add -> reduce -> residual.
    Ref: AdaptiveModule3, common.py:751-803 (conv/bn/leaky-relu 0.1).
    ``fused=True``: BN folded into conv weight and bias (deploy form).
    ``use_kernel=True`` (deploy, eval mode, needs ``fused``): the whole
    module runs as the fused CEM kernel (``nn.cem_cuda``), as ``use_pallas``
    does in the JAX package; a bf16 module takes the kernel's bf16 form, an
    f32 module its f32 form.  Same parameters either way.
    ``compose_tail=True`` (opt-in, off by default as in the JAX package;
    BN-folded, eval mode, without the kernel): the linear bank -> add ->
    conv3 tail runs as one composed 5x5 conv (``tail_composed``)."""

    def __init__(self, c: int = 3, fused: bool = False,
                 use_kernel: bool = False, compose_tail: bool = False):
        super().__init__()
        self.use_kernel = use_kernel
        self.compose_tail = compose_tail
        self._pack, self._pack_key = None, None
        self.conv2 = nn.Conv2d(c, c * 8, 3, 1, 1, bias=fused)
        self.bn2 = None if fused else batchnorm(c * 8)
        self.sobel = EnhanceConv(c * 8)
        self.conv3 = nn.Conv2d(c * 8, c, 3, 1, 1, bias=fused)
        self.bn3 = None if fused else batchnorm(c)

    def _kernel_forward(self, x):
        from mmidet_tpu_torch.nn.cem_cuda import fused_cem, pack_cem_weights
        if self.bn2 is not None or self.bn3 is not None:
            raise ValueError("the CEM kernel needs the BN-folded module "
                             "(fused=True or fold_batchnorm)")
        params = (self.conv2.weight.permute(2, 3, 1, 0), self.conv2.bias,
                  self.sobel.sobel_factor.flatten(), self.sobel.bias,
                  self.conv3.weight.permute(2, 3, 1, 0), self.conv3.bias)
        pack = None
        if x.device.type == "cuda" and torch.compiler.is_exporting():
            # a traced graph has no storage to stamp: the packing goes
            # into the graph and runs on every call
            pack = pack_cem_weights(*params, x.dtype)
        elif x.device.type == "cuda":
            # the kernel's weight buffer is kept until a parameter changes
            key = (x.device, x.dtype, kernels.stamp(self.parameters()))
            if key != self._pack_key:
                self._pack = pack_cem_weights(
                    *(p.to(x.device) for p in params), x.dtype)
                self._pack_key = key
            pack = self._pack
        return fused_cem(x.permute(0, 2, 3, 1), *params,
                         pack=pack).permute(0, 3, 1, 2)

    def forward(self, x):
        if self.use_kernel and not self.training:
            return self._kernel_forward(x)
        y = self.conv2(x)
        if self.bn2 is not None:
            y = self.bn2(y)
        y = F.leaky_relu(y, 0.1)
        if self.compose_tail and self.bn3 is None and not self.training:
            z = tail_composed(y, self.sobel.sobel_factor.flatten(),
                              self.sobel.bias, self.conv3.weight,
                              self.conv3.bias)
            return F.leaky_relu(z, 0.1) + x
        y = self.conv3(y + self.sobel(y))
        if self.bn3 is not None:
            y = self.bn3(y)
        return F.leaky_relu(y, 0.1) + x
