"""Greedy selection NMS: a hand-written CUDA kernel and its plain PyTorch
version.

Counterpart of ``mmidet_tpu/ops/nms_pallas.py``.  The kernel
(``csrc/nms_greedy.cu``) replaces the TPU kernel ``nms_greedy_pallas``
there, and both versions compute ``mmidet_tpu/ops/nms.py:_nms_single`` on
boxes that already carry the class offset: ``max_det`` steps of argmax
(lowest index on ties), IoU against the pool, suppression.  The plain version
takes those steps; the kernel sorts the pool by (score descending, index
ascending) and keeps, in that order, every candidate that no earlier kept
box suppresses, 64 candidates per dependent round.
"""

from __future__ import annotations

import torch

from mmidet_tpu_torch import kernels

MAX_POOL = 4096  # the kernel sorts the pool in shared memory


def nms_greedy_reference(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_thres: float = 0.45, max_det: int = 300):
    """boxes (B, K, 4) xyxy, scores (B, K) with -inf for invalid.
    Returns (keep_idx (B, max_det) int32, keep_valid (B, max_det) bool)."""
    b, k, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    pos = torch.arange(k, device=boxes.device)
    s = scores
    idx, val = [], []
    for _ in range(max_det):
        j = s.argmax(1, keepdim=True)                      # (B, 1)
        valid = s.gather(1, j) > -torch.inf
        xx1 = torch.maximum(x1, x1.gather(1, j))
        yy1 = torch.maximum(y1, y1.gather(1, j))
        xx2 = torch.minimum(x2, x2.gather(1, j))
        yy2 = torch.minimum(y2, y2.gather(1, j))
        inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
        iou = inter / (areas + areas.gather(1, j) - inter + 1e-9)
        suppress = (iou > iou_thres) | (pos[None] == j)
        s = torch.where(valid & suppress, -torch.inf, s)
        idx.append(torch.where(valid, j, 0)[:, 0])
        val.append(valid[:, 0])
    return (torch.stack(idx, 1).to(torch.int32), torch.stack(val, 1))


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thres: float = 0.45, max_det: int = 300,
               stats: torch.Tensor | None = None):
    """Batched greedy NMS.  On a CUDA tensor this launches the kernel (one
    block per image, sort and scan in one launch); on a CPU tensor it runs
    the plain version.  Scores are finite or -inf.

    ``stats``, a (B, 4) int32 tensor on the boxes' device, takes the
    kernel's own count of its scan per image: the dependent rounds, the
    sorted candidates they consumed, the boxes kept and the valid
    candidates.  Only the kernel fills it."""
    if boxes.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats count the kernel's scan; the plain "
                             "version has none")
        return nms_greedy_reference(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for {boxes.device}")
    b, k, four = boxes.shape
    if four != 4 or tuple(scores.shape) != (b, k) or not 0 < k <= MAX_POOL \
            or max_det < 1:
        raise ValueError(f"kernel takes boxes (B, K, 4) and scores (B, K) "
                         f"with K <= {MAX_POOL}; got {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}")
    if stats is not None and (stats.shape != (b, 4) or stats.dtype !=
                              torch.int32 or stats.device != boxes.device
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous ({b}, 4) int32 tensor "
                         f"on {boxes.device}")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    keep_idx = torch.empty((b, max_det), dtype=torch.int32,
                           device=boxes.device)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool,
                             device=boxes.device)
    fn = kernels.load("nms_greedy")
    err = fn(boxes.data_ptr(), scores.data_ptr(), keep_idx.data_ptr(),
             keep_valid.data_ptr(),
             None if stats is None else stats.data_ptr(), b, k, max_det,
             float(iou_thres), kernels.stream_ptr(boxes))
    kernels.check("nms_greedy", err)
    nms_greedy.launches += 1
    return keep_idx, keep_valid


nms_greedy.launches = 0
