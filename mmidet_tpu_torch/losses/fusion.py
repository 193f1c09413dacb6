"""Info-Guided / Contrast-Bridge auxiliary fusion losses.

Counterpart of ``mmidet_tpu/losses/fusion.py``; reference
``models/yolo_test.py:338-486`` (``ContrastiveLoss``,
``compute_contrastive_loss``, ``ssim_loss``, ``compute_fusing_loss2``,
``calculate_entropy``, ``compute_EntropyLoss``).  Features are NCHW.

Quirks kept, as the JAX package keeps them:
  * contrastive negatives are batch-shifted pairs (rgb[:-1] vs ir[1:] and
    rgb[1:] vs ir[:-1]); the loss form is ``exp(mean(d^2))`` with margin 1
    on negatives, averaged ``(2*pos + neg1 + neg2)/4``;
  * SSIM from *global* scalar moments of the whole tensor, biased
    variance; the contrast-consistency term uses the *unbiased* std;
  * the entropy term is a hard 256-bin histogram over [0, 1]
    (``torch.histc``), which has no gradient; ``soft=True`` gives a
    differentiable soft histogram.

``group`` (a ``parallel.comm.DataGroup``, as the detector passes it in a
data-parallel step): each rank holds its rows of the global batch, and
every mean, moment, count and histogram is the global batch's (partial
sums all-reduced over the data group, with autograd); the contrastive
pairs that cross a rank boundary take the next rank's first sample.
``group=None`` runs the one-process code.
"""

from __future__ import annotations

import torch

from mmidet_tpu_torch.parallel import comm


def _l2_normalize(x: torch.Tensor, dim: int,
                  eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize: x / max(||x||_2, eps)."""
    n = (x * x).sum(dim, keepdim=True).sqrt()
    return x / n.clamp(min=eps)


def _pair_loss(e1: torch.Tensor, e2: torch.Tensor, label: float,
               margin: float = 1.0) -> torch.Tensor:
    """Ref Model.ContrastiveLoss (yolo_test.py:338-354); ``label`` is the
    value of the (constant) label tensor."""
    d = _l2_normalize(e1 - e2, dim=1)  # channel axis (NCHW)
    e = torch.exp((d * d).mean())
    return (1.0 - label) * e + label * (e - margin)


def _sq_dist(e1: torch.Tensor, e2: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """sum over pairs i of w_i sum (normalize(e1_i - e2_i))^2."""
    d = _l2_normalize(e1 - e2, dim=1)
    return ((d * d).flatten(1).sum(1) * w).sum()


def contrastive_loss(rgb: torch.Tensor, ir: torch.Tensor,
                     margin: float = 1.0, group=None) -> torch.Tensor:
    """Contrast Bridge on the fusion-block inputs.  Ref:
    compute_contrastive_loss (yolo_test.py:356-404).  Needs batch >= 2
    (the reference gives NaN at batch 1); 0 there."""
    if group is None:
        if rgb.shape[0] < 2:
            return rgb.new_zeros(())
        pos = _pair_loss(rgb[:-1], ir[:-1], 0.0, margin)
        neg1 = _pair_loss(rgb[:-1], ir[1:], 1.0, margin)
        neg2 = _pair_loss(rgb[1:], ir[:-1], 1.0, margin)
        return (pos * 2 + neg1 + neg2) / 4.0
    if group.total < 2:
        return rgb.new_zeros(())
    # the pairs (i, i + 1) at this rank's end take the next rank's first
    # sample; the last rank's last pair does not exist and weighs 0 (every
    # rank runs the same operations, so that the backward's collectives
    # meet)
    b, r, n = rgb.shape[0], group.rank, group.size
    nxt = (r + 1) % n
    rgb = torch.cat([rgb, comm.gather_rows(rgb[:1], group.group)[nxt:nxt + 1]])
    ir = torch.cat([ir, comm.gather_rows(ir[:1], group.group)[nxt:nxt + 1]])
    w = torch.ones(b, device=rgb.device)
    if r == n - 1:
        w[-1] = 0.0
    sums = comm.global_sum([torch.stack([
        _sq_dist(rgb[:b], ir[:b], w), _sq_dist(rgb[:b], ir[1:], w),
        _sq_dist(rgb[1:], ir[:b], w)])], group.group)[0]
    e = torch.exp(sums / ((group.total - 1) * rgb[0].numel()))
    pos, neg1, neg2 = e[0], e[1] - margin, e[2] - margin
    return (pos * 2 + neg1 + neg2) / 4.0


def _means(group, *xs) -> list[torch.Tensor]:
    """The means of ``xs`` over the global batch (equal sizes a rank)."""
    n = xs[0].numel() * (1 if group is None else group.size)
    return [s / n for s in comm.global_sum(
        [x.sum() for x in xs], None if group is None else group.group)]


def ssim_global(img1: torch.Tensor, img2: torch.Tensor,
                group=None) -> torch.Tensor:
    """1 - SSIM from global scalar moments. Ref: ssim_loss
    (yolo_test.py:461-486)."""
    if group is None:
        mu1, mu2 = img1.mean(), img2.mean()
        var1 = ((img1 - mu1) ** 2).mean()
        var2 = ((img2 - mu2) ** 2).mean()
        cov = ((img1 - mu1) * (img2 - mu2)).mean()
    else:
        mu1, mu2 = _means(group, img1, img2)
        var1, var2, cov = _means(group, (img1 - mu1) ** 2,
                                 (img2 - mu2) ** 2,
                                 (img1 - mu1) * (img2 - mu2))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * cov + c2)
            / ((mu1 ** 2 + mu2 ** 2 + c1) * (var1 + var2 + c2)))
    return 1.0 - ssim


def _std_unbiased(x: torch.Tensor, group=None) -> torch.Tensor:
    if group is None:
        n = x.numel()
        return (((x - x.mean()) ** 2).sum() / max(n - 1, 1)).sqrt()
    n = x.numel() * group.size
    mu, = _means(group, x)
    ss, = comm.global_sum([((x - mu) ** 2).sum()], group.group)
    return (ss / max(n - 1, 1)).sqrt()


def fusing_loss(rgb_in: torch.Tensor, ir_in: torch.Tensor,
                fused_rgb: torch.Tensor, fused_ir: torch.Tensor,
                group=None) -> torch.Tensor:
    """Weighted SSIM + contrast consistency. Ref: compute_fusing_loss2
    (yolo_test.py:444-459)."""
    loss = 0.5 * ssim_global(rgb_in, fused_rgb, group) + \
        0.5 * ssim_global(ir_in, fused_ir, group)
    return loss + (_std_unbiased(fused_rgb, group)
                   - _std_unbiased(fused_ir, group)).abs()


def entropy_256(x: torch.Tensor, soft: bool = False,
                tau: float = 0.01, group=None) -> torch.Tensor:
    """Shannon entropy (bits) of the 256-bin histogram of ``x`` over
    [0, 1].  Ref: calculate_entropy (yolo_test.py:424-429): values outside
    [0, 1] are ignored and the hard histogram has no gradient."""
    xf = x.float().reshape(-1)
    if soft:
        centers = (torch.arange(256, dtype=torch.float32,
                                device=x.device) + 0.5) / 256.0
        w = torch.softmax(-(xf[:, None] - centers[None]) ** 2 / tau, -1)
        in_range = ((xf >= 0) & (xf <= 1)).float()
        hist = (w * in_range[:, None]).sum(0)
    else:
        xf = xf.detach()
        in_range = ((xf >= 0) & (xf <= 1)).float()
        idx = torch.floor(xf * 256.0).long().clamp(0, 255)
        hist = torch.zeros(256, device=x.device).index_add_(0, idx,
                                                            in_range)
    if group is not None:
        hist, = comm.global_sum([hist], group.group)
    p = hist / hist.sum().clamp(min=1e-12)
    plogp = torch.where(p > 0, p * torch.log2(p.clamp(min=1e-30)),
                        torch.zeros_like(p))
    return -plogp.sum()


def entropy_loss(rgb_in: torch.Tensor, ir_in: torch.Tensor,
                 fused: torch.Tensor, soft: bool = False,
                 group=None) -> torch.Tensor:
    """(H(rgb) + H(ir)) - H(fused). Ref: compute_EntropyLoss
    (yolo_test.py:406-422)."""
    return (entropy_256(rgb_in, soft, group=group)
            + entropy_256(ir_in, soft, group=group)
            - entropy_256(fused, soft, group=group))
