"""Paired augmentation on the card, batched: per-modality HSV, shared
flips, and the affine/perspective warp with its label transform.

Counterpart of the non-mosaic part of ``mmidet_tpu/data/augment.py``
(:38-190 and :386-434); reference ``utils/datasets.py``:
``random_perspective_rgb_ir`` (2154-2263), ``augment_hsv`` (applied with
*independent* random gains per modality, datasets.py:1512-1515) and the
flips (shared across modalities).  Mosaic, quad, mixup and cutout wait for
ROADMAP A14.

Images are NHWC floats in [0, 1] on the card; labels normalized xywh with
a class column, ``(B, T, 5)`` with a ``(B, T)`` mask.  The random draws
come from an explicit ``torch.Generator`` on the images' device.  JAX's
draws cannot be repeated in torch, so every random function has a
deterministic core that takes its draws (HSV gains, flip decisions, the
warp matrix) and a ``*_draws`` function that makes them.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AugmentHyp:
    """Augmentation hyperparameters (data/hyp.scratch.yaml:24-33)."""
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0


def _uniform(shape, lo: float, hi: float, gen: torch.Generator):
    return torch.rand(shape, generator=gen, device=gen.device) * \
        (hi - lo) + lo


# ------------------------------------------------------------------ color

def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x.unbind(-1)
    mx = x.amax(-1)
    mn = x.amin(-1)
    d = mx - mn + 1e-12
    h = torch.where(mx == r, ((g - b) / d) % 6.0,
                    torch.where(mx == g, (b - r) / d + 2.0,
                                (r - g) / d + 4.0))
    h = (h / 6.0) % 1.0
    s = torch.where(mx > 0, d / (mx + 1e-12), torch.zeros_like(mx))
    return torch.stack([h, s, mx], -1)


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """The branchless form of the JAX package (no gather)."""
    h, s, v = x.unbind(-1)
    h6 = h * 6.0

    def chan(n):
        k = (n + h6) % 6.0
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], -1)


def hsv_gains(b: int, hyp: AugmentHyp, gen: torch.Generator
              ) -> torch.Tensor:
    """(B, 3) multiplicative h/s/v gains ~ U(1 - g, 1 + g) (the reference's
    r = uniform(-1, 1) * gain + 1)."""
    r = _uniform((b, 3), -1.0, 1.0, gen)
    return r * torch.tensor([hyp.hsv_h, hyp.hsv_s, hyp.hsv_v],
                            device=r.device) + 1.0


def augment_hsv(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) in [0, 1]; gains (B, 3)."""
    hsv = rgb_to_hsv(img)
    g = gains[:, None, None, :]
    h = (hsv[..., 0] * g[..., 0]) % 1.0
    s = (hsv[..., 1] * g[..., 1]).clamp(0.0, 1.0)
    v = (hsv[..., 2] * g[..., 2]).clamp(0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], -1))


# --------------------------------------------------------------- geometry

def perspective_draws(b: int, hyp: AugmentHyp, gen: torch.Generator
                      ) -> dict:
    """The draws of ``_perspective_matrix`` for B images."""
    return {"p": _uniform((b, 2), -hyp.perspective, hyp.perspective, gen),
            "a": _uniform((b,), -hyp.degrees, hyp.degrees, gen),
            "s": _uniform((b,), 1 - hyp.scale, 1 + hyp.scale, gen),
            "sh": _uniform((b, 2), -hyp.shear, hyp.shear, gen),
            "t": _uniform((b, 2), 0.5 - hyp.translate, 0.5 + hyp.translate,
                          gen)}


def _perspective_matrix(draws: dict, width: int, height: int, border: int):
    """(B, 3, 3) src->dst matrices and the sampled scales, in the
    reference's composition M = T @ S @ R @ P @ C
    (datasets.py random_perspective)."""
    p, a, s, sh, t = (draws[k] for k in ("p", "a", "s", "sh", "t"))
    b, dev, dt = a.shape[0], a.device, a.dtype

    def eye():
        return torch.eye(3, device=dev, dtype=dt).repeat(b, 1, 1)
    C = eye()
    C[:, 0, 2], C[:, 1, 2] = -width / 2, -height / 2
    P = eye()
    P[:, 2, 0], P[:, 2, 1] = p[:, 0], p[:, 1]
    rad = a * math.pi / 180.0
    ca, sa = torch.cos(rad) * s, torch.sin(rad) * s
    R = eye()
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = ca, sa, -sa, ca
    tan = torch.tan(sh * math.pi / 180.0)
    S = eye()
    S[:, 0, 1], S[:, 1, 0] = tan[:, 0], tan[:, 1]
    T = eye()
    T[:, 0, 2] = t[:, 0] * (width - 2 * border)
    T[:, 1, 2] = t[:, 1] * (height - 2 * border)
    # the sampled scale comes back too: the reference's box_candidates
    # gate scales the pre-warp box by it (datasets.py:2258, box1 * s)
    return T @ S @ R @ P @ C, s


def warp_image(img: torch.Tensor, M: torch.Tensor, out_hw: tuple[int, int],
               fill: float = 114.0 / 255.0) -> torch.Tensor:
    """img (B, H, W, C) through the src->dst matrices M (B, 3, 3):
    bilinear, each of the four neighbours outside the image read as
    ``fill`` (``map_coordinates(order=1, mode="constant")``)."""
    b, h, w, c = img.shape
    oh, ow = out_hw
    dev, dt = img.device, img.dtype
    ys, xs = torch.meshgrid(torch.arange(oh, device=dev, dtype=dt),
                            torch.arange(ow, device=dev, dtype=dt),
                            indexing="ij")
    dst = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(oh * ow, device=dev, dtype=dt)])
    src = torch.linalg.inv(M.to(dt)) @ dst  # (B, 3, oh*ow)
    sx, sy = src[:, 0] / src[:, 2], src[:, 1] / src[:, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    flat = img.reshape(b, h * w, c)
    out = torch.zeros(b, oh * ow, c, device=dev, dtype=dt)
    for yi, wy in ((y0, 1 - (sy - y0)), (y0 + 1, sy - y0)):
        for xi, wx in ((x0, 1 - (sx - x0)), (x0 + 1, sx - x0)):
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            val = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            out = out + (wy * wx)[..., None] * torch.where(
                ok[..., None], val, torch.full_like(val, fill))
    return out.reshape(b, oh, ow, c)


def transform_labels(labels_xyxy: torch.Tensor, mask: torch.Tensor,
                     M: torch.Tensor, out_hw: tuple[int, int],
                     perspective: bool = False, scale=1.0):
    """Warp xyxy boxes (..., N, 4) through M (..., 3, 3); clip to the
    output; the reference's box_candidates gate (wh > 2 px, area ratio >
    0.1, aspect < 20) on top of ``mask``.  ``scale`` (..., ) is the
    sampled scale of the warp.  Returns (boxes, mask)."""
    oh, ow = out_hw
    x1, y1, x2, y2 = labels_xyxy.unbind(-1)
    corners = torch.stack([torch.stack([x1, y1], -1),
                           torch.stack([x2, y1], -1),
                           torch.stack([x1, y2], -1),
                           torch.stack([x2, y2], -1)], -2)  # (..., N, 4, 2)
    pts = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    warped = (pts.flatten(-3, -2) @ M.transpose(-1, -2)).reshape(pts.shape)
    if perspective:
        warped = warped[..., :2] / warped[..., 2:3]
    else:
        warped = warped[..., :2]
    nx1 = warped[..., 0].amin(-1).clamp(0, ow)
    nx2 = warped[..., 0].amax(-1).clamp(0, ow)
    ny1 = warped[..., 1].amin(-1).clamp(0, oh)
    ny2 = warped[..., 1].amax(-1).clamp(0, oh)
    new = torch.stack([nx1, ny1, nx2, ny2], -1)
    scale = torch.as_tensor(scale, dtype=labels_xyxy.dtype,
                            device=labels_xyxy.device)
    if scale.dim():
        scale = scale[..., None]
    # the area ratio's denominator is the SCALED pre-warp box, as the
    # reference's box_candidates(box1=targets[:, 1:5].T * s, ...) call
    w1, h1 = (x2 - x1) * scale, (y2 - y1) * scale
    w2, h2 = nx2 - nx1, ny2 - ny1
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    keep = ((w2 > 2) & (h2 > 2)
            & (w2 * h2 / (w1 * h1 + 1e-16) > 0.1) & (ar < 20))
    return new, mask & keep


# ------------------------------------------------------ the no-mosaic path

def basic_draws(b: int, hyp: AugmentHyp, gen: torch.Generator) -> dict:
    """The draws of ``augment_pair_basic`` for B pairs: HSV gains per
    modality, and shared up-down and left-right flips."""
    return {"gains_rgb": hsv_gains(b, hyp, gen),
            "gains_ir": hsv_gains(b, hyp, gen),
            "flipud": _uniform((b,), 0.0, 1.0, gen) < hyp.flipud,
            "fliplr": _uniform((b,), 0.0, 1.0, gen) < hyp.fliplr}


def augment_pair_basic(rgb, ir, labels, mask, draws: dict):
    """No-mosaic path on letterboxed pairs: per-modality HSV, then the
    shared flips; labels stay normalized xywh, padded rows zeroed."""
    rgb = augment_hsv(rgb, draws["gains_rgb"])
    ir = augment_hsv(ir, draws["gains_ir"])
    ud = draws["flipud"][:, None, None, None]
    lr = draws["fliplr"][:, None, None, None]
    rgb = torch.where(ud, rgb.flip(1), rgb)
    ir = torch.where(ud, ir.flip(1), ir)
    rgb = torch.where(lr, rgb.flip(2), rgb)
    ir = torch.where(lr, ir.flip(2), ir)
    cx = torch.where(draws["fliplr"][:, None], 1.0 - labels[..., 1],
                     labels[..., 1])
    cy = torch.where(draws["flipud"][:, None], 1.0 - labels[..., 2],
                     labels[..., 2])
    labels = torch.stack([labels[..., 0], cx, cy, labels[..., 3],
                          labels[..., 4]], -1)
    labels = torch.where(mask[..., None], labels, torch.zeros_like(labels))
    return rgb, ir, labels, mask


def make_batch_augment(s: int, hyp: AugmentHyp, max_labels: int,
                       mosaic: bool = False):
    """Returns ``fn(batch, gen) -> batch`` over dict(rgb, ir, targets,
    mask) on the card.  ``mosaic=True`` (the JAX package's default) is
    ROADMAP A14."""
    if mosaic:
        raise NotImplementedError("mosaic augmentation is not ported yet "
                                  "(ROADMAP A14)")

    def fn(batch: dict, gen: torch.Generator) -> dict:
        draws = basic_draws(batch["rgb"].shape[0], hyp, gen)
        rgb, ir, lab, m = augment_pair_basic(
            batch["rgb"], batch["ir"], batch["targets"], batch["mask"],
            draws)
        return {"rgb": rgb, "ir": ir, "targets": lab, "mask": m}
    return fn
