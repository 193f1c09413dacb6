"""Detection metrics: AP per class (COCO 101-point interp), F1-peak P/R,
fitness, confusion matrix, and the eval-time IoU matching.

A copy of ``mmidet_tpu/eval/metrics.py`` (host-side numpy; the port imports
nothing of the JAX package); reference ``utils/metrics.py:12-183`` and the
per-image TP assignment loop in ``test.py:198-231``.
"""

from __future__ import annotations

import numpy as np
import torch

from mmidet_tpu_torch.ops.boxes import box_iou


def fitness(metrics4: np.ndarray) -> np.ndarray:
    """0.1*mAP@.5 + 0.9*mAP@.5:.95 over [P, R, mAP50, mAP]. Ref:
    metrics.py:12-15."""
    w = np.asarray([0.0, 0.0, 0.1, 0.9])
    return (np.asarray(metrics4)[..., :4] * w).sum(-1)


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """COCO 101-point interpolated AP. Ref: metrics.py:83-108."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") \
        else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray):
    """PR curves + AP per class.

    Args: tp (N, niou) bool, conf (N,), pred_cls (N,), target_cls (M,).
    Returns (p, r, ap, f1, unique_classes) — p/r/f1 at the max-F1 confidence
    (ref metrics.py:18-80).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes = np.unique(target_cls)
    nc = classes.shape[0]
    niou = tp.shape[1] if tp.ndim > 1 else 1
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, niou))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(classes):
        sel = pred_cls == c
        n_l = int((target_cls == c).sum())
        if not sel.any() or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(niou):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])
    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + 1e-16)
    i = f1.mean(0).argmax()
    return (p_curve[:, i], r_curve[:, i], ap, f1[:, i],
            classes.astype(np.int32))


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU on numpy arrays
    (``ops.boxes.box_iou``)."""
    return box_iou(torch.from_numpy(np.asarray(a)),
                   torch.from_numpy(np.asarray(b)), eps).numpy()


def match_predictions(pred: np.ndarray, labels: np.ndarray,
                      iouv: np.ndarray) -> np.ndarray:
    """Per-image TP assignment against a vector of IoU thresholds.

    pred: (N, 6) [x1,y1,x2,y2,conf,cls]; labels: (M, 5) [cls,x1,y1,x2,y2].
    Returns correct (N, len(iouv)) bool.  Ref: test.py:198-231 (per-class
    greedy best-IoU matching with a detected-target set).
    """
    correct = np.zeros((pred.shape[0], iouv.shape[0]), bool)
    if labels.shape[0] == 0 or pred.shape[0] == 0:
        return correct
    # Single-pass vectorized form of the reference's greedy loop
    # (test.py:198-231).  Exact by construction:
    #   * the reference restricts each pred's best target to SAME-CLASS
    #     labels — identical to masking cross-class IoUs to -1 (a masked
    #     entry can never beat the > iouv[0] >= 0 candidate gate);
    #   * a candidate claims its best target iff it is the FIRST candidate
    #     (in pred order) for that target; the reference's class-by-class
    #     processing order is irrelevant because targets are
    #     class-exclusive, and within a class its pi order IS pred order;
    #   * the break-on-ALL-labels-matched quirk (test.py:228) is
    #     outcome-neutral — it only triggers once every label is detected,
    #     after which no later candidate could claim anything anyway.
    iou = box_iou_np(pred[:, :4], labels[:, 1:5])
    iou = np.where(pred[:, 5:6] == labels[None, :, 0], iou, -1.0)
    best = iou.argmax(1)
    best_iou = iou[np.arange(pred.shape[0]), best]
    cand = np.nonzero(best_iou > iouv[0])[0]  # candidates, in pred order
    if cand.size == 0:
        return correct
    win = cand[np.unique(best[cand], return_index=True)[1]]  # first claims
    correct[win] = best_iou[win, None] > iouv[None, :]
    return correct


class ConfusionMatrix:
    """IoU-matched confusion matrix with background row/col.
    Ref: metrics.py:111-183."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (N,6) xyxy+conf+cls; labels (M,5) cls+xyxy."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        if labels.shape[0] and detections.shape[0]:
            iou = box_iou_np(labels[:, 1:], detections[:, :4])
            li, di = np.nonzero(iou > self.iou_thres)
            matches = np.stack([li, di, iou[li, di]], 1)
            if matches.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1],
                                            return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0],
                                            return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1 = matches[:, 0].astype(int), matches[:, 1].astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1  # background FP
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FN


def coco80_to_coco91_class() -> list[int]:
    """COCO 80-index (detection order) -> 91-index (paper category ids)
    mapping — the standard table of valid category ids with the 11 unused
    ids skipped.  Ref: general.py:299-308, applied to COCO JSON dumps
    (test.py:91,169)."""
    skipped = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    return [i for i in range(1, 92) if i not in skipped]
