"""Host-side image preparation.  A copy of
``mmidet_tpu/data/datasets.py:letterbox_np`` (the port imports nothing of
the JAX package)."""

from __future__ import annotations

import numpy as np


def letterbox_np(img: np.ndarray, new_shape: tuple[int, int] = (640, 640),
                 color: int = 114, scaleup: bool = True):
    """Aspect-preserving resize + pad (ref ``letterbox``, datasets.py:2016).
    Returns (out, ratio, (dw, dh))."""
    from PIL import Image
    h, w = img.shape[:2]
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = (new_shape[1] - nw) / 2, (new_shape[0] - nh) / 2
    if (w, h) != (nw, nh):
        img = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), color,
                  img.dtype)
    out[top:top + nh, left:left + nw] = img
    return out, r, (dw, dh)
