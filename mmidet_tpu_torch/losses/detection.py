"""YOLOv5 detection loss with the Info-Guided fusion-loss hook, at fixed
shapes.

Counterpart of ``mmidet_tpu/losses/detection.py``; reference
``utils/loss.py`` (``ComputeLoss``, ``build_targets``, ``FocalLoss``,
``QFocalLoss``, ``smooth_BCE``) and the fusion-loss merge at
``loss.py:159-184``.

``build_targets`` is reformulated without boolean-mask indexing (which
would sync the host with the card): every (image, target slot, anchor,
offset) tuple is a *candidate* with a validity mask.  Targets arrive padded
to ``T`` per image, the candidate tensor is ``(B, T, na, 5)``, and gathers
and scatters use linear indices into the flattened prediction grid.

Objectness on duplicate cells is the reference's last write
(``loss.py:249``, in build_targets' offset-block / anchor / target row
order): an int scatter-max of the write-order sequence picks each cell's
winning candidate, then only the winners scatter their value.  Both
scatters are ``scatter_reduce_(..., "amax")``, which is deterministic on
CUDA, where ``index_put_``/``scatter_`` with duplicate indices are not.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from mmidet_tpu_torch.ops.boxes import bbox_iou
from mmidet_tpu_torch.parallel import comm

# duplicate-cell objectness: "last" is the reference's last write
# (loss.py:249); "max" lets every valid candidate compete and the largest
# IoU win, the JAX package's A/B arm (its tools/ab_exactness.py)
OBJ_DUP_MODE = "last"

# candidate offsets (reference loss.py:198-201), bias g = 0.5
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


@dataclasses.dataclass(frozen=True)
class LossHyp:
    """The loss-relevant hyperparameters (data/hyp.scratch.yaml:14-23)."""
    box: float = 0.05
    cls: float = 0.5
    cls_pw: float = 1.0
    obj: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0
    gr: float = 1.0           # iou ratio (train.py sets model.gr = 1.0)
    aux_weight: float = 0.1   # alpha_Contrast (loss.py:113)


def smooth_bce(eps: float = 0.0) -> tuple[float, float]:
    """Positive/negative label-smoothing targets. Ref: loss.py:10-12."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise BCE-with-logits; ``pos_weight`` scales the target term
    (torch's ``BCEWithLogitsLoss(pos_weight=)``)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_modulation(logits, targets, loss, gamma: float = 1.5,
                     alpha: float = 0.25):
    """TF-style focal wrapper. Ref: FocalLoss (loss.py:32-59)."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * (1.0 - p_t) ** gamma


def qfocal_modulation(logits, targets, loss, gamma: float = 1.5,
                      alpha: float = 0.25):
    """Quality focal wrapper. Ref: QFocalLoss (loss.py:62-85)."""
    p = torch.sigmoid(logits)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * (targets - p).abs() ** gamma


def bce_blur_with_logits(logits, targets, alpha: float = 0.05,
                         pos_weight: float = 1.0):
    """BCE with reduced missing-label effects. Ref: BCEBlurWithLogitsLoss
    (loss.py:15-29)."""
    loss = bce_with_logits(logits, targets, pos_weight)
    dx = torch.sigmoid(logits) - targets
    alpha_factor = 1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4))
    return (loss * alpha_factor).mean()


def build_candidates(targets: torch.Tensor, mask: torch.Tensor,
                     anchors_l: torch.Tensor, ny: int, nx: int,
                     anchor_t: float) -> dict:
    """Fixed-shape target assignment for one detection level.

    targets (B, T, 5) [class, x, y, w, h] normalized; mask (B, T) bool;
    anchors_l (na, 2) in grid units.  Returns a dict of (B, T, na, 5)
    candidate fields: valid, b, a, gi, gj, txy (+2), twh (+2), tcls, seq
    (the reference's write order, 1-based), anchor (+2)."""
    bsz, t, _ = targets.shape
    na = anchors_l.shape[0]
    dev, dt = targets.device, targets.dtype
    gain = torch.tensor([nx, ny, nx, ny], dtype=dt, device=dev)
    xywh = targets[..., 1:5] * gain  # grid units

    # anchor-ratio gate (loss.py:212-215): (B, T, na)
    r = xywh[..., None, 2:4] / anchors_l[None, None]
    ratio = torch.maximum(r, 1.0 / r).amax(-1)
    match = (ratio < anchor_t) & mask[..., None]

    gxy = xywh[..., :2]
    gxi = gain[:2] - gxy
    # neighbour-cell conditions (loss.py:218-222)
    jm = (gxy % 1.0 < 0.5) & (gxy > 1.0)
    lm = (gxi % 1.0 < 0.5) & (gxi > 1.0)
    cond = torch.stack([torch.ones_like(jm[..., 0]), jm[..., 0], jm[..., 1],
                        lm[..., 0], lm[..., 1]], -1)  # (B, T, 5)
    valid = match[..., None] & cond[..., None, :]  # (B, T, na, 5)

    off = torch.tensor(_OFFSETS, dtype=dt, device=dev)
    gij = torch.floor(gxy[..., None, :] - off).long()
    # clamped before txy, as the reference's in-place clamp_ (loss.py:239)
    gij = torch.stack([gij[..., 0].clamp(0, nx - 1),
                       gij[..., 1].clamp(0, ny - 1)], -1)
    shape = (bsz, t, na, 5)
    gi = gij[..., 0][:, :, None].expand(shape)
    gj = gij[..., 1][:, :, None].expand(shape)
    txy = (gxy[..., None, :] - gij.to(dt))[:, :, None].expand(shape + (2,))
    twh = xywh[..., None, None, 2:4].expand(shape + (2,))
    ar = torch.arange
    bidx = ar(bsz, device=dev)[:, None, None, None].expand(shape)
    aidx = ar(na, device=dev)[None, None, :, None].expand(shape)
    oidx = ar(5, device=dev)[None, None, None, :].expand(shape)
    tidx = ar(t, device=dev)[None, :, None, None].expand(shape)
    # the reference's write order: offset-block-major (loss.py:232), then
    # anchor, then target; its in-place tobj write keeps the LAST row
    seq = (((oidx * na + aidx) * bsz + bidx) * t + tidx) + 1
    return {"valid": valid, "b": bidx, "a": aidx, "gi": gi, "gj": gj,
            "txy": txy, "twh": twh,
            "tcls": targets[..., 0].long()[..., None, None].expand(shape),
            "seq": seq,
            "anchor": anchors_l[None, None, :, None, :].expand(shape + (2,))}


def _scatter_max(size: int, index: torch.Tensor, src: torch.Tensor
                 ) -> torch.Tensor:
    """``zeros(size).at[index].max(src, mode="drop")``: a negative index
    counts from the end, as in numpy; one outside [-size, size) lands in
    a spare slot that is dropped."""
    index = torch.where(index < 0, index + size, index)
    index = torch.where((index >= 0) & (index < size), index,
                        torch.full_like(index, size))
    out = torch.zeros(size + 1, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, index, src, "amax")[:size]


def compute_loss(train_outs: Sequence[torch.Tensor], targets: torch.Tensor,
                 target_mask: torch.Tensor, anchors: torch.Tensor,
                 hyp: LossHyp = LossHyp(), combine_loss=None,
                 balance: Sequence[float] | None = None, group=None):
    """YOLOv5 + Info-Guided loss. Ref: ComputeLoss.__call__
    (loss.py:113-184).

    train_outs: per-level (B, na, ny, nx, no) raw predictions; targets
    (B, T, 5) padded [class, x, y, w, h] normalized; target_mask (B, T)
    bool; anchors (nl, na, 2) in grid units; combine_loss: the model's
    fusion Combine loss or None, merged as ``combine * aux_weight``
    (loss.py:161-175).

    Returns (total, metrics of 0-dim tensors); ``total`` carries the
    reference's ``* batch_size``.  Everything is computed in f32.

    ``group`` (a ``parallel.comm.DataGroup``): the inputs are this rank's
    rows of a global batch, and the loss is the global batch's, the same
    on every rank: the matched-candidate counts, the objectness mean and
    the batch size are summed over the data group (with autograd)."""
    if balance is None:
        # reference per-level objectness balance (loss.py:106)
        balance = {3: (4.0, 1.0, 0.4)}.get(
            len(train_outs), (4.0, 1.0, 0.25, 0.06, 0.02)[:len(train_outs)])
    nc = train_outs[0].shape[-1] - 5
    bsz = train_outs[0].shape[0] if group is None else group.total
    pg = None if group is None else group.group
    dev = train_outs[0].device
    cp, cn = smooth_bce(hyp.label_smoothing)
    targets = targets.float()
    lbox = torch.zeros((), device=dev)
    lobj = torch.zeros((), device=dev)
    lcls = torch.zeros((), device=dev)

    for i, pi in enumerate(train_outs):
        pi = pi.float()
        b_, na, ny, nx, no = pi.shape
        cand = build_candidates(targets, target_mask,
                                anchors[i].float().to(dev), ny, nx,
                                hyp.anchor_t)
        valid = cand["valid"].reshape(-1)
        w = valid.float()
        if group is None:
            n = w.sum().clamp(min=1.0)
        else:
            n = comm.global_sum([w.sum()], pg)[0].clamp(min=1.0)

        # linear index into the flattened (B, na, ny, nx) grid
        lin = (((cand["b"] * na + cand["a"]) * ny + cand["gj"]) * nx
               + cand["gi"]).reshape(-1)
        flat = pi.reshape(-1, no)
        ps = flat[lin]  # (K, no)

        pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * \
            cand["anchor"].reshape(-1, 2)
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([cand["txy"].reshape(-1, 2),
                          cand["twh"].reshape(-1, 2)], -1)
        iou = bbox_iou(pbox, tbox, xywh=True, CIoU=True)
        box_sum = ((1.0 - iou) * w).sum()
        if group is not None:
            box_sum, = comm.global_sum([box_sum], pg)
        lbox = lbox + box_sum / n

        # objectness target: the last write on duplicate cells, by an int
        # scatter-max of the write order, then the winners' values
        with torch.no_grad():
            cells = b_ * na * ny * nx
            tobj_val = (1.0 - hyp.gr) + hyp.gr * iou.detach().clamp(min=0.0)
            if OBJ_DUP_MODE == "last":
                seq = torch.where(valid, cand["seq"].reshape(-1), 0)
                win = _scatter_max(cells, lin, seq)
                is_winner = valid & (seq == win[lin])
            else:
                is_winner = valid
            tobj = _scatter_max(cells, lin, torch.where(
                is_winner, tobj_val, -1.0)).clamp(min=0.0)

        obj_bce = bce_with_logits(flat[:, 4], tobj, hyp.obj_pw)
        if hyp.fl_gamma > 0:
            obj_bce = focal_modulation(flat[:, 4], tobj, obj_bce,
                                       hyp.fl_gamma)
        if group is None:
            lobj = lobj + obj_bce.mean() * balance[i]
        else:
            obj_sum, = comm.global_sum([obj_bce.sum()], pg)
            lobj = lobj + obj_sum / (bsz * cells // b_) * balance[i]

        if nc > 1:
            tcl = (cand["tcls"].reshape(-1, 1)
                   == torch.arange(nc, device=dev)).float()
            tcl = tcl * (cp - cn) + cn
            cls_bce = bce_with_logits(ps[:, 5:], tcl, hyp.cls_pw)
            if hyp.fl_gamma > 0:
                cls_bce = focal_modulation(ps[:, 5:], tcl, cls_bce,
                                           hyp.fl_gamma)
            cls_sum = (cls_bce.mean(-1) * w).sum()
            if group is not None:
                cls_sum, = comm.global_sum([cls_sum], pg)
            lcls = lcls + cls_sum / n

    lbox = lbox * hyp.box
    lobj = lobj * hyp.obj
    lcls = lcls * hyp.cls
    detect = lbox + lobj + lcls
    if combine_loss is not None:
        aux = torch.as_tensor(combine_loss, device=dev).float() * \
            hyp.aux_weight
    else:
        aux = torch.zeros((), device=dev)
    total = (detect + aux) * bsz
    return total, {"box": lbox, "obj": lobj, "cls": lcls, "detect": detect,
                   "aux": aux, "total": total}
