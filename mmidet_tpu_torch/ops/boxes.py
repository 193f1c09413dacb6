"""Box geometry: coordinate conversions and the IoU family
(IoU/GIoU/DIoU/CIoU).

Counterpart of ``mmidet_tpu/ops/boxes.py``; reference
``utils/general.py:311-483`` (xyxy2xywh, xywh2xyxy, xywhn2xyxy,
scale_coords, clip_coords, bbox_iou, box_iou, wh_iou).  Every function is
elementwise with broadcasting: boxes are ``(..., 4)`` and ``bbox_iou``
gives ``(...)`` (the reference takes box1 as 4xN and transposes box2).
"""

from __future__ import annotations

import math

import torch


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1,y1,x2,y2] -> [cx,cy,w,h]. Ref: general.py:311."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx,cy,w,h] -> [x1,y1,x2,y2]. Ref: general.py:321."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xywhn2xyxy(x: torch.Tensor, w: float = 640, h: float = 640,
               padw: float = 0, padh: float = 0) -> torch.Tensor:
    """Normalised [cx,cy,w,h] -> pixel [x1,y1,x2,y2]. Ref: general.py:331."""
    cx, cy, bw, bh = x.unbind(-1)
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh],
                       -1)


def clip_coords(boxes: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to image (height, width). Ref: general.py:395."""
    h, w = shape
    hi = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes.clamp(min=0), hi)


def scale_coords(img1_shape, coords: torch.Tensor, img0_shape,
                 ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy coords from the letterboxed ``img1_shape`` back to
    ``img0_shape`` (height, width); ``ratio_pad`` ((gain, gain), (padw,
    padh)) as the loaders give it.  Ref: general.py:377 (a new tensor, not
    in place)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0],
                   img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    shift = torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                         dtype=coords.dtype, device=coords.device)
    return clip_coords((coords - shift) / gain, img0_shape)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, xywh: bool = False,
             GIoU: bool = False, DIoU: bool = False, CIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise (broadcasting) IoU between box1 (..., 4) and box2
    (..., 4).  The reference's arithmetic (general.py:403-447), its quirk
    included: ``+eps`` lands on h1/h2 but not on w1/w2.  CIoU's alpha
    carries no gradient, as the reference's ``torch.no_grad()`` block."""
    if xywh:
        cx1, cy1, w1_, h1_ = box1.unbind(-1)
        cx2, cy2, w2_, h2_ = box2.unbind(-1)
        b1_x1, b1_x2 = cx1 - w1_ / 2, cx1 + w1_ / 2
        b1_y1, b1_y2 = cy1 - h1_ / 2, cy1 + h1_ / 2
        b2_x1, b2_x2 = cx2 - w2_ / 2, cx2 + w2_ / 2
        b2_y1, b2_y2 = cy2 - h2_ / 2, cy2 + h2_ / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1))
             .clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1))
             .clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if GIoU or DIoU or CIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if CIoU or DIoU:
            c2 = cw ** 2 + ch ** 2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                    + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if DIoU:
                return iou - rho2 / c2
            v = (4 / math.pi ** 2) * (torch.atan(w2 / h2)
                                      - torch.atan(w1 / h1)) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            return iou - (rho2 / c2 + v * alpha)
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    return iou


def box_iou(box1: torch.Tensor, box2: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU matrix (N, M) of xyxy boxes (N, 4) and (M, 4).
    Ref: general.py:450."""
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = torch.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = torch.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """(N, 2) x (M, 2) -> (N, M) IoU of boxes sharing a centre.
    Ref: general.py:477."""
    inter = torch.minimum(wh1[:, None], wh2[None]).prod(2)
    return inter / (wh1.prod(-1)[:, None] + wh2.prod(-1)[None] - inter)
