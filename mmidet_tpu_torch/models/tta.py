"""Test-time-augmented (TTA) inference.

Counterpart of ``mmidet_tpu/models/tta.py``; reference
``Model.forward(augment=True)`` (``models/yolo.py:121-138`` /
``models/yolo_test.py:140-160``): three passes at scales (1, 0.83, 0.67)
with an lr-flip on the second, boxes de-scaled/de-flipped and
concatenated, and ``scale_img`` (``utils/torch_utils.py:247-257``):
bilinear resize + bottom/right pad to a stride multiple with the 0.447
ImageNet-mean gray.

The reference's two-stream augment path calls ``self.forward_once(xi)``
without the IR input (``yolo_test.py:149``), a ``TypeError`` on any call;
here, as in the JAX package, both modalities are transformed identically.
Images are NHWC, as the detector takes them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from mmidet_tpu_torch.nn.resize import bilinear_resize

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, "lr", None)   # reference f = [None, 3, None]


def scale_img(img: torch.Tensor, ratio: float = 1.0, gs: int = 32,
              value: float = 0.447) -> torch.Tensor:
    """NHWC scale by ``ratio`` + pad to gs-multiples (ref scale_img,
    torch_utils.py:247-257; same_shape=False branch)."""
    if ratio == 1.0:
        return img
    h, w = img.shape[1:3]
    s = (int(h * ratio), int(w * ratio))
    im = bilinear_resize(img.permute(0, 3, 1, 2), s)
    ph = math.ceil(h * ratio / gs) * gs - s[0]
    pw = math.ceil(w * ratio / gs) * gs - s[1]
    return F.pad(im, (0, pw, 0, ph), value=value).permute(0, 2, 3, 1)


def forward_tta(apply_fn: Callable, rgb: torch.Tensor,
                ir: torch.Tensor | None = None, gs: int = 32) -> torch.Tensor:
    """Augmented inference: ``apply_fn(rgb[, ir]) -> (B, N, no)`` decoded
    predictions; returns the three legs' predictions concatenated on N."""
    h, w = rgb.shape[1:3]
    outs = []
    for si, fi in zip(TTA_SCALES, TTA_FLIPS):
        def prep(x):
            if fi == "lr":
                x = torch.flip(x, dims=(2,))
            elif fi == "ud":
                x = torch.flip(x, dims=(1,))
            return scale_img(x, si, gs)
        p = apply_fn(prep(rgb)) if ir is None else \
            apply_fn(prep(rgb), prep(ir))
        p = torch.cat([p[..., :4] / si, p[..., 4:]], -1)
        if fi == "ud":     # de-flip (ref yolo.py:133-136)
            p[..., 1] = h - p[..., 1]
        elif fi == "lr":
            p[..., 0] = w - p[..., 0]
        outs.append(p)
    return torch.cat(outs, 1)
