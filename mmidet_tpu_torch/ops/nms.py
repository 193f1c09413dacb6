"""Fixed-shape batched non-maximum suppression.

Counterpart of ``mmidet_tpu/ops/nms.py:non_max_suppression``; reference
``non_max_suppression`` (``utils/general.py:486-580``):

  * conf = obj_conf * cls_conf (general.py:529);
  * ``multi_label``: every (box, class) pair above ``conf_thres`` is a
    candidate (general.py:536-537), else best class only (general.py:539);
  * the ``classes`` filter (general.py:540-545);
  * top-K by confidence caps the pool (general.py:555-557);
  * boxes are shifted by ``class_id * max_wh`` so classes never overlap
    (general.py:560-562), then greedy selection NMS (``ops.nms_cuda``);
  * optional merge-NMS (general.py:566-574).

Output is always ``(B, max_det, 6)`` plus a validity mask.
"""

from __future__ import annotations

import torch

from mmidet_tpu_torch.ops.boxes import xywh2xyxy
from mmidet_tpu_torch.ops.nms_cuda import nms_greedy


def _merge_boxes(cboxes, scores, oboxes, keep_idx, keep_valid, iou_thres,
                 out_boxes):
    """Merge-NMS on a batch (``nms.py:70-100``): kept box i becomes the
    score-weighted mean of every valid candidate whose class-offset IoU
    with it exceeds ``iou_thres``; kept boxes matched by nothing but
    themselves are dropped.  A no-op unless 1 < n < 3000 candidates are
    valid."""
    pool_valid = scores > -torch.inf                          # (B, K)
    n = pool_valid.sum(1, keepdim=True)
    kept = torch.gather(oboxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    x1 = torch.maximum(kept[:, :, None, 0], oboxes[:, None, :, 0])
    y1 = torch.maximum(kept[:, :, None, 1], oboxes[:, None, :, 1])
    x2 = torch.minimum(kept[:, :, None, 2], oboxes[:, None, :, 2])
    y2 = torch.minimum(kept[:, :, None, 3], oboxes[:, None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)

    def area(b):
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])

    union = area(kept)[:, :, None] + area(oboxes)[:, None, :] - inter
    match = (inter / (union + 1e-9) > iou_thres) & pool_valid[:, None, :]
    w = torch.where(match, scores[:, None, :], 0.0)
    merged = (w @ cboxes) / w.sum(2, keepdim=True).clamp(min=1e-9)
    apply = (n > 1) & (n < 3000)                               # (B, 1)
    out_boxes = torch.where((apply & keep_valid)[..., None], merged,
                            out_boxes)
    keep_valid = keep_valid & torch.where(apply, match.sum(2) > 1, True)
    return out_boxes, keep_valid


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, max_det: int = 300,
                        pre_nms_topk: int = 4096, multi_label: bool = False,
                        agnostic: bool = False, max_wh: float = 4096.0,
                        classes: tuple | None = None, merge: bool = False):
    """prediction (B, N, 5+nc) decoded [cx, cy, w, h, obj, cls...].
    Returns dets (B, max_det, 6) [x1, y1, x2, y2, conf, cls], zero-padded,
    and valid (B, max_det) bool."""
    prediction = prediction.float()
    b, n_box, no = prediction.shape
    nc = no - 5
    use_multi = multi_label and nc > 1
    cls_conf = prediction[..., 5:] * prediction[..., 4:5]
    cls_keep = None
    if classes is not None:
        cls_keep = torch.zeros(nc, dtype=torch.bool, device=prediction.device)
        cls_keep[list(classes)] = True
    boxes = xywh2xyxy(prediction[..., :4])
    neg_inf = torch.tensor(-torch.inf, device=prediction.device)

    if use_multi:
        if cls_keep is not None:
            cls_conf = torch.where(cls_keep, cls_conf, 0.0)
        flat = cls_conf.reshape(b, -1)
        flat = torch.where(flat > conf_thres, flat, neg_inf)
        scores, idx = torch.topk(flat, min(pre_nms_topk, flat.shape[1]), 1)
        bidx = idx // nc
        cls_ids = (idx % nc).float()
    else:
        conf, cidx = cls_conf.max(2)
        if cls_keep is not None:
            conf = torch.where(cls_keep[cidx], conf, neg_inf)
        conf = torch.where(conf > conf_thres, conf, neg_inf)
        scores, bidx = torch.topk(conf, min(pre_nms_topk, n_box), 1)
        cls_ids = torch.gather(cidx, 1, bidx).float()
    cboxes = torch.gather(boxes, 1, bidx[..., None].expand(-1, -1, 4))
    offset = torch.zeros_like(cls_ids) if agnostic else cls_ids * max_wh
    oboxes = cboxes + offset[..., None]

    keep_idx, keep_valid = nms_greedy(oboxes, scores, iou_thres, max_det)
    keep_idx = keep_idx.long()
    out_boxes = torch.gather(cboxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(scores, 1, keep_idx)
    out_classes = torch.gather(cls_ids, 1, keep_idx)
    if merge:
        out_boxes, keep_valid = _merge_boxes(
            cboxes, scores, oboxes, keep_idx, keep_valid, iou_thres,
            out_boxes)
    dets = torch.cat([out_boxes, out_scores[..., None],
                      out_classes[..., None]], 2)
    dets = torch.where(keep_valid[..., None], dets, 0.0)
    return dets, keep_valid
