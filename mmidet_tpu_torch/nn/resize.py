"""Resampling for the fusion blocks, on NCHW tensors.

Counterpart of ``mmidet_tpu/nn/resize.py``.  The JAX package writes these
as constant matrix products pinned to torch's semantics; here they are the
torch operators themselves:

  * adaptive pooling windows ``start = floor(i*H/out)``,
    ``end = ceil((i+1)*H/out)`` (``F.adaptive_avg_pool2d``);
  * bilinear with half-pixel centers, edges clamped
    (``F.interpolate(mode="bilinear", align_corners=False)``);
  * nearest-neighbour upsample by an integer factor.

The JAX package's constant matrices themselves (``_adaptive_avg_weights``,
``_bilinear_weights``) are kept as well, for the ONNX emitter
(``deploy/onnx_export.py``), which writes the resampling as MatMuls.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, out_hw)


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


@functools.lru_cache(maxsize=None)
def _adaptive_avg_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix replicating AdaptiveAvgPool1d
    (JAX ``nn/resize.py``); the ONNX emitter writes it as a MatMul."""
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = math.ceil((i + 1) * n_in / n_out)
        w[i, start:end] = 1.0 / (end - start)
    return w


@functools.lru_cache(maxsize=None)
def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix, half-pixel centers, edges
    clamped (JAX ``nn/resize.py``); the ONNX emitter writes it as a
    MatMul."""
    w = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), n_in - 1)
        lo = int(math.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w
