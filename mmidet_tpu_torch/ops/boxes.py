"""Box geometry the NMS path needs.  Counterpart of
``mmidet_tpu/ops/boxes.py`` (reference ``utils/general.py:321``)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx,cy,w,h] -> [x1,y1,x2,y2]. Ref: general.py:321."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
