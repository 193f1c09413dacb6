"""Resampling for the fusion blocks, on NCHW tensors.

Counterpart of ``mmidet_tpu/nn/resize.py``.  The JAX package writes these
as constant matrix products pinned to torch's semantics; here they are the
torch operators themselves:

  * adaptive pooling windows ``start = floor(i*H/out)``,
    ``end = ceil((i+1)*H/out)`` (``F.adaptive_avg_pool2d``);
  * bilinear with half-pixel centers, edges clamped
    (``F.interpolate(mode="bilinear", align_corners=False)``);
  * nearest-neighbour upsample by an integer factor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, out_hw)


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")
