"""Paired augmentation on the card, batched: mosaic, per-modality HSV,
shared flips, the affine/perspective warp with its label transform, the
``--quad`` collate, and the single-stream extras (mixup, cutout, histogram
equalisation, the 9-tile mosaic, small-box replication).

Counterpart of ``mmidet_tpu/data/augment.py``; reference
``utils/datasets.py``: ``load_mosaic_RGB_IR`` (1764-1913),
``random_perspective_rgb_ir`` (2154-2263), ``augment_hsv`` (applied with
*independent* random gains per modality, datasets.py:1512-1515), the flips
(shared across modalities) and ``collate_fn4`` (1020-1046).

Images are NHWC floats in [0, 1] on the card; labels normalized xywh with
a class column, ``(B, T, 5)`` with a ``(B, T)`` mask.  The random draws
come from an explicit ``torch.Generator`` on the images' device.  JAX's
draws cannot be repeated in torch, so every random function has a
deterministic core that takes its draws (HSV gains, flip decisions, the
warp matrix, the mosaic centre, ...) and a ``*_draws`` function that makes
them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from mmidet_tpu_torch.nn.resize import bilinear_resize

FILL = 114.0 / 255.0


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
               fill: float = FILL) -> torch.Tensor:
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


# ----------------------------------------------------------------- mosaic

def _mosaic_geometry(center: torch.Tensor, s: int, pads=None):
    """Mosaic centres and per-tile top-left offsets, for B samples.  Ref:
    datasets.py:1777-1778: (xc, yc) ~ U(s/2, 3s/2), rounded (half to even,
    as ``jnp.round``).

    center: (B, 2) the unrounded draws (x, y).  ``pads``: (B, 4, 4) [top,
    left, nh, nw], where each tile's CONTENT sits inside its letterboxed
    square; shifting each tile by its pad anchors the content corner at
    the centre, the reference's aspect-shaped placement
    (datasets.py:1780-1795).  ``pads=None`` anchors the full tiles.
    Returns xc, yc (B,) and offs (B, 4, 2): (ty, tx) per tile."""
    c = torch.round(center)
    xc, yc = c[:, 0], c[:, 1]
    if pads is None:
        z = torch.zeros_like(xc)[:, None]
        top = left = z.expand(-1, 4)
        nh = nw = torch.full_like(top, float(s))
    else:
        top, left, nh, nw = pads.unbind(-1)
    ty = torch.stack([yc - (top[:, 0] + nh[:, 0]), yc - (top[:, 1] + nh[:, 1]),
                      yc - top[:, 2], yc - top[:, 3]], 1)
    tx = torch.stack([xc - (left[:, 0] + nw[:, 0]), xc - left[:, 1],
                      xc - (left[:, 2] + nw[:, 2]), xc - left[:, 3]], 1)
    return xc, yc, torch.stack([ty, tx], -1)


def _mosaic_labels(labels, mask, offs, s: int):
    """Per-tile normalized xywh labels (B, 4, T, 5) -> canvas xyxy
    (B, 4T, 4) clipped to [0, 2s], classes (B, 4T), mask (B, 4T)."""
    b, _, t, _ = labels.shape
    ty, tx = offs[..., 0, None], offs[..., 1, None]
    cx, cy = labels[..., 1] * s, labels[..., 2] * s
    w, h = labels[..., 3] * s, labels[..., 4] * s
    boxes = torch.stack([cx - w / 2 + tx, cy - h / 2 + ty,
                         cx + w / 2 + tx, cy + h / 2 + ty], -1)
    return (boxes.reshape(b, 4 * t, 4).clamp(0, 2 * s),
            labels[..., 0].reshape(b, 4 * t), mask.reshape(b, 4 * t))


def _quadrant(ys: torch.Tensor, xs: torch.Tensor, yc, xc) -> torch.Tensor:
    """(B, H, W) tile index of each pixel: 0 tl, 1 tr, 2 bl, 3 br."""
    return (2 * (ys[None, :, None] >= yc[:, None, None]).long()
            + (xs[None, None, :] >= xc[:, None, None]).long())


def mosaic4(tiles: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
            center: torch.Tensor, s: int, fill: float = FILL, pads=None):
    """4 (s, s, C) tiles a sample -> (2s, 2s, C) mosaic canvas + shifted
    xyxy labels: the general-warp path.  Each tile is placed by integer
    translation (nearest sampling, ``fill`` outside the tile) in the
    quadrant of the centre it belongs to.

    tiles (B, 4, s, s, C); labels (B, 4, T, 5); mask (B, 4, T); center
    (B, 2) as ``_mosaic_geometry``.  Returns canvas (B, 2s, 2s, C), boxes
    (B, 4T, 4), cls (B, 4T), mask (B, 4T)."""
    b, _, _, _, c = tiles.shape
    xc, yc, offs = _mosaic_geometry(center, s, pads)
    ar = torch.arange(2 * s, device=tiles.device, dtype=tiles.dtype)
    q = _quadrant(ar, ar, yc, xc)                              # (B, 2s, 2s)
    off = torch.gather(offs, 1, q.reshape(b, -1, 1).expand(-1, -1, 2))
    ty = ar[None, :, None] - off[..., 0].reshape(q.shape)      # tile row
    tx = ar[None, None, :] - off[..., 1].reshape(q.shape)      # tile col
    ok = (ty >= 0) & (ty <= s - 1) & (tx >= 0) & (tx <= s - 1)
    idx = (q * s + ty.clamp(0, s - 1).long()) * s + tx.clamp(0, s - 1).long()
    val = torch.gather(tiles.reshape(b, 4 * s * s, c), 1,
                       idx.reshape(b, -1, 1).expand(-1, -1, c))
    canvas = torch.where(ok.reshape(b, -1, 1), val, torch.full_like(
        val, fill)).reshape(b, 2 * s, 2 * s, c)
    boxes, cls, m = _mosaic_labels(labels, mask, offs, s)
    return canvas, boxes, cls, m


def _linear_taps(a, t, n: int, size: int):
    """``jax.image.scale_and_translate``'s linear weights (its
    ``compute_weight_mat``, antialias off) for output indices 0..n-1 of an
    axis of ``size`` inputs, scale ``a`` and translation ``t`` (both
    (...,)), as two taps an output: [(index, weight), (index, weight)].
    Each output's weights are divided by their sum (zero when the sum is
    below 1000 f32 eps) and are zero where its sample point lies outside
    [-0.5, size - 0.5]."""
    inv = 1.0 / a
    o = torch.arange(n, device=a.device, dtype=a.dtype)
    sf = (o + 0.5) * inv[..., None] - (t * inv)[..., None] - 0.5
    j0 = torch.floor(sf)
    taps = []
    for j in (j0, j0 + 1):
        w = (1 - (sf - j).abs()).clamp_min(0)
        taps.append((j, torch.where((j >= 0) & (j <= size - 1), w,
                                    torch.zeros_like(w))))
    total = taps[0][1] + taps[1][1]
    keep = (total.abs() > 1000.0 * torch.finfo(torch.float32).eps) & \
        (sf >= -0.5) & (sf <= size - 0.5)
    div = torch.where(total != 0, total, torch.ones_like(total))
    return [(j.clamp(0, size - 1).long(),
             torch.where(keep, w / div, torch.zeros_like(w)))
            for j, w in taps]


def mosaic_warp_fast(tiles: torch.Tensor, offs: torch.Tensor, center,
                     M: torch.Tensor, s: int, fill: float = FILL
                     ) -> torch.Tensor:
    """Mosaic and axis-aligned warp in one, without the 2s x 2s canvas.

    Valid when degrees == shear == perspective == 0 (the default hyp): M is
    a scale ``a`` and a translation, so each output pixel lies in one tile
    by a per-axis affine.  The JAX package resamples every tile with
    ``jax.image.scale_and_translate(..., method="linear",
    antialias=False)`` on ``tiles - fill`` padded by 1 px (so that the
    border blends toward ``fill`` as the reference's constant-border warp
    does), then selects by quadrant in output space.  Here each output
    pixel reads its own tile only: that function's two taps an axis,
    weighted as it weights them (``_linear_taps``).  As in the JAX
    package, taps do not blend across the quadrant seams.

    tiles (B, 4, s, s, C); offs (B, 4, 2) and center (xc, yc) from
    ``_mosaic_geometry``; M (B, 3, 3).  Returns (B, s, s, C)."""
    xc, yc = center
    b, _, _, _, c = tiles.shape
    n = s + 2                                     # the 1-px padded tile
    a, tx, ty = M[:, 0, 0], M[:, 0, 2], M[:, 1, 2]
    ar = torch.arange(s, device=tiles.device, dtype=tiles.dtype)
    q = _quadrant(ar, ar, a * yc + ty, a * xc + tx)          # (B, s, s)
    half = 0.5 * (1.0 - a)
    # half-pixel centres: in = (o + 0.5 - T) / a - 0.5 with T = a * off + t
    # + 0.5 * (1 - a), i.e. in = (o - (a * off + t)) / a
    rows = _linear_taps(a[:, None], a[:, None] * (offs[..., 0] - 1)
                        + ty[:, None] + half[:, None], s, n)   # (B, 4, s)
    cols = _linear_taps(a[:, None], a[:, None] * (offs[..., 1] - 1)
                        + tx[:, None] + half[:, None], s, n)
    yy = ar.long()[None, :, None]
    xx = ar.long()[None, None, :]

    def per_pixel(v, pos):  # v (B, 4, s) by tile -> (B, s, s) by q
        return torch.gather(v.reshape(b, 4 * s), 1,
                            (q * s + pos).reshape(b, -1)).reshape(b, s, s)
    padded = F.pad(tiles - fill, (0, 0, 1, 1, 1, 1)).reshape(b, 4 * n * n, c)

    def read(jy, jx):
        idx = (q * n + jy) * n + jx
        return torch.gather(padded, 1, idx.reshape(b, -1, 1).expand(
            -1, -1, c)).reshape(b, s, s, c)
    taps_y = [(per_pixel(j, yy), per_pixel(w, yy)[..., None])
              for j, w in rows]
    taps_x = [(per_pixel(j, xx), per_pixel(w, xx)[..., None])
              for j, w in cols]
    # the rows first, then the columns (each sum holds two products)
    out = 0.0
    for jx, wx in taps_x:
        (jy0, wy0), (jy1, wy1) = taps_y
        out = out + wx * (wy0 * read(jy0, jx) + wy1 * read(jy1, jx))
    return out + fill


def mosaic_draws(b: int, s: int, hyp: AugmentHyp, gen: torch.Generator
                 ) -> dict:
    """The draws of ``augment_pair_mosaic`` for B samples: the mosaic
    centres ~ U(s/2, 3s/2)^2 (x, y), the warp's (``perspective_draws``),
    HSV gains per modality, and shared up-down and left-right flips."""
    return {"center": _uniform((b, 2), 0.5 * s, 1.5 * s, gen),
            "warp": perspective_draws(b, hyp, gen), **basic_draws(b, hyp, gen)}


def _flip(rgb, ir, draws):
    ud = draws["flipud"][:, None, None, None]
    lr = draws["fliplr"][:, None, None, None]
    rgb = torch.where(ud, rgb.flip(1), rgb)
    ir = torch.where(ud, ir.flip(1), ir)
    return torch.where(lr, rgb.flip(2), rgb), torch.where(lr, ir.flip(2), ir)


def augment_pair_mosaic(rgb4, ir4, labels4, mask4, draws: dict, s: int,
                        hyp: AugmentHyp, max_labels: int, pads4=None):
    """Paired mosaic + shared warp + per-modality HSV + shared flips.

    rgb4/ir4: (B, 4, s, s, 3) in [0, 1]; labels4: (B, 4, T, 5) normalized;
    mask4: (B, 4, T); pads4: (B, 4, 4) letterbox content placement (see
    ``_mosaic_geometry``) or None.  One warp matrix a sample serves both
    modalities.  Returns (rgb, ir, labels (B, max_labels, 5) normalized
    xywh, mask): the valid labels first in their order, padded rows
    zeroed."""
    M, s_scale = _perspective_matrix(draws["warp"], 2 * s, 2 * s, s // 2)
    if hyp.degrees == 0 and hyp.shear == 0 and hyp.perspective == 0:
        # the axis-aligned path of the default hyp: no canvas, no gather
        # warp (see mosaic_warp_fast)
        xc, yc, offs = _mosaic_geometry(draws["center"], s, pads4)
        boxes, cls, m = _mosaic_labels(labels4, mask4, offs, s)
        rgb = mosaic_warp_fast(rgb4, offs, (xc, yc), M, s)
        ir = mosaic_warp_fast(ir4, offs, (xc, yc), M, s)
    else:
        rgb_c, boxes, cls, m = mosaic4(rgb4, labels4, mask4,
                                       draws["center"], s, pads=pads4)
        ir_c = mosaic4(ir4, labels4, mask4, draws["center"], s,
                       pads=pads4)[0]
        rgb = warp_image(rgb_c, M, (s, s))
        ir = warp_image(ir_c, M, (s, s))
    boxes, m = transform_labels(boxes, m, M, (s, s),
                                perspective=hyp.perspective > 0,
                                scale=s_scale)
    rgb = augment_hsv(rgb, draws["gains_rgb"])
    ir = augment_hsv(ir, draws["gains_ir"])
    rgb, ir = _flip(rgb, ir, draws)
    x1, y1, x2, y2 = boxes.unbind(-1)
    lr, ud = draws["fliplr"][:, None], draws["flipud"][:, None]
    x1, x2 = torch.where(lr, s - x2, x1), torch.where(lr, s - x1, x2)
    y1, y2 = torch.where(ud, s - y2, y1), torch.where(ud, s - y1, y2)
    lab = torch.stack([cls, (x1 + x2) / 2 / s, (y1 + y2) / 2 / s,
                       (x2 - x1) / s, (y2 - y1) / s], -1)
    # the valid labels first, in their order (a stable sort of ~mask on
    # an integer view), cropped to max_labels
    order = torch.argsort((~m).to(torch.int32), dim=1,
                          stable=True)[:, :max_labels]
    lab = torch.gather(lab, 1, order[..., None].expand(-1, -1, 5))
    m = torch.gather(m, 1, order)
    lab = torch.where(m[..., None], lab, torch.zeros_like(lab))
    return rgb, ir, lab, m


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
    rgb, ir = _flip(rgb, ir, draws)
    cx = torch.where(draws["fliplr"][:, None], 1.0 - labels[..., 1],
                     labels[..., 1])
    cy = torch.where(draws["flipud"][:, None], 1.0 - labels[..., 2],
                     labels[..., 2])
    labels = torch.stack([labels[..., 0], cx, cy, labels[..., 3],
                          labels[..., 4]], -1)
    labels = torch.where(mask[..., None], labels, torch.zeros_like(labels))
    return rgb, ir, labels, mask


def take_rows(draws, rows: slice | None):
    """``rows`` of every tensor of a draws tree (None: all)."""
    if rows is None:
        return draws
    if isinstance(draws, dict):
        return {k: take_rows(v, rows) for k, v in draws.items()}
    return draws[rows]


def make_batch_augment(s: int, hyp: AugmentHyp, max_labels: int,
                       mosaic: bool = True):
    """Returns ``fn(batch, gen) -> dict(rgb, ir, targets, mask)`` on the
    card, over dict(rgb4, ir4, labels4, mask4[, pads4]) (``mosaic``, the
    default, as the JAX package's) or dict(rgb, ir, targets, mask).
    ``fn(batch, gen, rows, total)``: ``batch`` holds ``rows`` of a global
    batch of ``total``; the draws are made for all of it and its rows
    taken (a data-parallel rank's share)."""
    if mosaic:
        def fn(batch: dict, gen: torch.Generator, rows=None,
               total=None) -> dict:
            draws = take_rows(mosaic_draws(
                total or batch["rgb4"].shape[0], s, hyp, gen), rows)
            rgb, ir, lab, m = augment_pair_mosaic(
                batch["rgb4"], batch["ir4"], batch["labels4"],
                batch["mask4"], draws, s, hyp, max_labels,
                pads4=batch.get("pads4"))
            return {"rgb": rgb, "ir": ir, "targets": lab, "mask": m}
        return fn

    def fn(batch: dict, gen: torch.Generator, rows=None,
           total=None) -> dict:
        draws = take_rows(basic_draws(total or batch["rgb"].shape[0], hyp,
                                      gen), rows)
        rgb, ir, lab, m = augment_pair_basic(
            batch["rgb"], batch["ir"], batch["targets"], batch["mask"],
            draws)
        return {"rgb": rgb, "ir": ir, "targets": lab, "mask": m}
    return fn


def resize_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) images to size x size, bilinear (the NCHW resize,
    permuted)."""
    return bilinear_resize(x.permute(0, 3, 1, 2),
                           (size, size)).permute(0, 2, 3, 1)


def quad_draws(g: int, gen: torch.Generator) -> torch.Tensor:
    """``quad_batch``'s draw for G groups: take the upscale (p = 0.5)."""
    return _uniform((g,), 0.0, 1.0, gen) < 0.5


def quad_batch(rgb, ir, targets, mask, take_up: torch.Tensor) -> dict:
    """The reference's ``--quad`` collate (``collate_fn4``,
    datasets.py:1020-1046, and its two-stream twin): each group of 4
    samples becomes ONE sample at twice the size: where ``take_up`` (G,),
    a bilinear 2x upscale of the group's FIRST image with its labels only
    (as the reference), else a 2x2 mosaic of all four (tiles 0/1 stacked
    in the left column, 2/3 in the right) with labels offset and halved.

    rgb/ir: (B, s, s, C); targets: (B, T, 5) normalized cls, xywh; mask:
    (B, T).  Returns dict(rgb, ir, targets, mask) at (B/4, 2s, 2s, C),
    (B/4, 4T, 5), (B/4, 4T)."""
    b, s = rgb.shape[0], rgb.shape[1]
    if b % 4:
        raise ValueError(f"--quad needs batch % 4 == 0, got {b}")
    g, t = b // 4, targets.shape[1]

    def grp(x):
        return x.reshape((g, 4) + tuple(x.shape[1:]))
    r4, i4, l4, m4 = grp(rgb), grp(ir), grp(targets), grp(mask)

    def mosaic22(t4):
        left = torch.cat([t4[:, 0], t4[:, 1]], 1)
        right = torch.cat([t4[:, 2], t4[:, 3]], 1)
        return torch.cat([left, right], 2)

    # label remap: tile 1 y += 1, tile 2 x += 1, tile 3 both; xywh *= 0.5
    offx = torch.tensor([0.0, 0.0, 1.0, 1.0], device=rgb.device)[None, :, None]
    offy = torch.tensor([0.0, 1.0, 0.0, 1.0], device=rgb.device)[None, :, None]
    lm = torch.stack([l4[..., 0], (l4[..., 1] + offx) * 0.5,
                      (l4[..., 2] + offy) * 0.5, l4[..., 3] * 0.5,
                      l4[..., 4] * 0.5], -1).reshape(g, 4 * t, 5)
    lu = torch.cat([l4[:, 0], torch.zeros_like(l4[:, 0]).repeat(1, 3, 1)], 1)
    mu = torch.cat([m4[:, 0], torch.zeros_like(m4[:, 0]).repeat(1, 3)], 1)
    sel = take_up[:, None, None, None]
    return {"rgb": torch.where(sel, resize_nhwc(r4[:, 0], 2 * s),
                               mosaic22(r4)),
            "ir": torch.where(sel, resize_nhwc(i4[:, 0], 2 * s),
                              mosaic22(i4)),
            "targets": torch.where(take_up[:, None, None], lu, lm),
            "mask": torch.where(take_up[:, None], mu, m4.reshape(g, 4 * t))}


# ------------------------------- single-stream extras (datasets.py:1607-2322)

def mixup_draws(b: int, gen: torch.Generator) -> torch.Tensor:
    """(B,) ratios ~ Beta(8, 8): X / (X + Y) with X, Y ~ Gamma(8), each a
    sum of 8 unit exponentials."""
    g = -torch.log1p(-torch.rand((b, 2, 8), generator=gen,
                                 device=gen.device)).sum(-1)
    return g[:, 0] / (g[:, 0] + g[:, 1])


def mixup(img1, labels1, mask1, img2, labels2, mask2, r: torch.Tensor):
    """Image mixup at ratios ``r`` (B,); the labels concatenate
    (datasets.py mixup).  Images (B, H, W, C), labels (B, T, 5)."""
    rr = r[:, None, None, None]
    return (img1 * rr + img2 * (1.0 - rr), torch.cat([labels1, labels2], 1),
            torch.cat([mask1, mask2], 1))


CUTOUT_SCALES = ([0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
                 + [0.03125] * 16)


def cutout_draws(b: int, h: int, w: int, gen: torch.Generator,
                 fill_low: float = 64 / 255, fill_high: float = 191 / 255
                 ) -> dict:
    """``cutout``'s draws for B images of h x w, per mask of
    ``CUTOUT_SCALES``: its height and width ~ randint(1, dim * scale)
    inclusive, its centre ~ randint(0, dim) inclusive, its colour ~
    U(fill_low, fill_high)^3."""
    def randint(lo, hi):  # (B, n) in [lo, hi), hi per mask
        hi = torch.tensor(hi, device=gen.device, dtype=torch.float64)
        u = torch.rand((b, len(hi)), generator=gen, device=gen.device,
                       dtype=torch.float64)
        return (lo + torch.floor(u * (hi - lo))).long()
    n = len(CUTOUT_SCALES)
    return {"mh": randint(1, [max(int(h * s), 1) + 1 for s in CUTOUT_SCALES]),
            "mw": randint(1, [max(int(w * s), 1) + 1 for s in CUTOUT_SCALES]),
            "cy": randint(0, [h + 1] * n), "cx": randint(0, [w + 1] * n),
            "fill": _uniform((b, n, 3), fill_low, fill_high, gen)}


def cutout(img, draws: dict, labels_xyxy=None, mask=None):
    """Random occlusion rectangles, the reference's schedule and semantics
    (datasets.py:2295-2320): ``CUTOUT_SCALES`` masks; labels more than 60%
    obscured by a mask of scale > 0.03 are dropped.  img (B, H, W, C);
    labels_xyxy (B, N, 4) in pixels.  Returns img when labels_xyxy is
    None, else (img, mask)."""
    b, h, w = img.shape[:3]
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    out, keep = img, mask
    for i, s in enumerate(CUTOUT_SCALES):
        mh, mw = draws["mh"][:, i], draws["mw"][:, i]
        ymin = (draws["cy"][:, i] - mh // 2).clamp(0, h)
        ymax = (ymin + mh).clamp(0, h)
        xmin = (draws["cx"][:, i] - mw // 2).clamp(0, w)
        xmax = (xmin + mw).clamp(0, w)
        box = ((ys >= ymin[:, None, None]) & (ys < ymax[:, None, None])
               & (xs >= xmin[:, None, None]) & (xs < xmax[:, None, None]))
        out = torch.where(box[..., None], draws["fill"][:, i, None, None, :],
                          out)
        if keep is not None and s > 0.03:
            # drop labels > 60% obscured (intersection over label area)
            lx1, ly1, lx2, ly2 = labels_xyxy.unbind(-1)
            iw = (torch.minimum(lx2, xmax[:, None].to(lx2.dtype))
                  - torch.maximum(lx1, xmin[:, None].to(lx1.dtype))
                  ).clamp_min(0)
            ih = (torch.minimum(ly2, ymax[:, None].to(ly2.dtype))
                  - torch.maximum(ly1, ymin[:, None].to(ly1.dtype))
                  ).clamp_min(0)
            ioa = iw * ih / ((lx2 - lx1) * (ly2 - ly1) + 1e-16)
            keep = keep & (ioa < 0.60)
    return out if labels_xyxy is None else (out, keep)


def _rgb_yuv(img):
    """BT.601 RGB -> YUV (the reference equalizes cv2's YUV luma,
    datasets.py:1677-1688)."""
    r, g, b = img.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.14713 * r - 0.28886 * g + 0.436 * b
    v = 0.615 * r - 0.51499 * g - 0.10001 * b
    return y, u, v


def _yuv_rgb(y, u, v):
    r = y + 1.13983 * v
    g = y - 0.39465 * u - 0.58060 * v
    b = y + 2.03211 * u
    return torch.stack([r, g, b], -1).clamp(0.0, 1.0)


def hist_equalize(img, clahe: bool = True, clip_limit: float = 2.0,
                  tiles: int = 8):
    """Luma histogram equalization (datasets.py hist_equalize) of (B, H, W,
    3) images: CLAHE by default (clip-limited per-tile histograms of the
    YUV luma, the 4 neighbouring tiles' mappings blended bilinearly, the
    cv2.createCLAHE(2.0, (8, 8)) algorithm in floats) or a global
    equalizeHist when ``clahe=False``.  H and W must be divisible by
    ``tiles``."""
    y, u, v = _rgb_yuv(img)
    b, h, w = y.shape
    idx = (y * 255.0).to(torch.int32).clamp(0, 255).long()
    if not clahe:
        hist = torch.zeros(b, 256, device=img.device, dtype=img.dtype)
        hist.scatter_add_(1, idx.reshape(b, -1),
                          torch.ones_like(y).reshape(b, -1))
        cdf = hist.cumsum(1)
        cdf = (cdf - cdf[:, :1]) / (cdf[:, -1:] - cdf[:, :1]).clamp_min(1e-6)
        return _yuv_rgb(torch.gather(cdf, 1, idx.reshape(b, -1)).reshape(
            b, h, w), u, v)
    th, tw = h // tiles, w // tiles
    tidx = idx.reshape(b, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4)
    hist = torch.zeros(b, tiles, tiles, 256, device=img.device,
                       dtype=img.dtype)
    hist.scatter_add_(3, tidx.reshape(b, tiles, tiles, -1),
                      torch.ones(tidx.shape, device=img.device,
                                 dtype=img.dtype).reshape(b, tiles, tiles, -1))
    # clip-limited redistribution; cv2 floors the limit at one count
    clip = max(clip_limit * (th * tw) / 256.0, 1.0)
    clipped = hist.clamp_max(clip)
    clipped = clipped + (hist - clipped).sum(-1, keepdim=True) / 256.0
    cdf = clipped.cumsum(-1)
    cdf = cdf / cdf[..., -1:].clamp_min(1e-6)          # (B, T, T, 256)
    # bilinear blend of the 4 neighbouring tile mappings at each pixel
    dev = img.device
    ys = (torch.arange(h, device=dev) + 0.5) / th - 0.5  # tile-grid coords
    xs = (torch.arange(w, device=dev) + 0.5) / tw - 0.5
    y0 = torch.floor(ys).long().clamp(0, tiles - 1)
    x0 = torch.floor(xs).long().clamp(0, tiles - 1)
    y1, x1 = (y0 + 1).clamp(0, tiles - 1), (x0 + 1).clamp(0, tiles - 1)
    fy = (ys - y0).clamp(0.0, 1.0)[:, None].to(img.dtype)
    fx = (xs - x0).clamp(0.0, 1.0)[None, :].to(img.dtype)
    flat = cdf.reshape(b, -1)

    def m(ty, tx):  # the mapping of tile (ty, tx) at each pixel's level
        i = ((ty[:, None] * tiles + tx[None, :]) * 256)[None] + idx
        return torch.gather(flat, 1, i.reshape(b, -1)).reshape(b, h, w)
    y_eq = ((1 - fy) * ((1 - fx) * m(y0, x0) + fx * m(y0, x1))
            + fy * ((1 - fx) * m(y1, x0) + fx * m(y1, x1)))
    return _yuv_rgb(y_eq, u, v)


def mosaic9_draws(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    """``mosaic9``'s crop origins (B, 2) (y, x) ~ randint(0, 2s)."""
    return torch.randint(0, 2 * s, (b, 2), generator=gen, device=gen.device)


def mosaic9(tiles, labels, mask, off: torch.Tensor, s: int):
    """9-image mosaic (datasets.py load_mosaic9), fixed-shape: the 3x3
    tiling of letterboxed tiles, then an s x s crop at ``off`` (B, 2).

    tiles (B, 9, s, s, C); labels (B, 9, T, 5) normalized; mask (B, 9, T).
    Returns (crop (B, s, s, C), boxes_xyxy (B, 9T, 4), cls, mask) in crop
    coordinates; boxes of 2 px or less are masked out."""
    b, _, _, _, c = tiles.shape
    t = labels.shape[2]
    canvas = tiles.reshape(b, 3, 3, s, s, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, 3 * s, 3 * s, c)
    ar = torch.arange(s, device=tiles.device)
    rows = off[:, 0, None] + ar                                   # (B, s)
    cols = off[:, 1, None] + ar
    crop = canvas[torch.arange(b, device=tiles.device)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]
    grid = torch.arange(9, device=tiles.device)
    r, cc = (grid // 3).to(labels.dtype), (grid % 3).to(labels.dtype)
    offy = off[:, 0].to(labels.dtype)[:, None, None]
    offx = off[:, 1].to(labels.dtype)[:, None, None]
    cx = labels[..., 1] * s + cc[None, :, None] * s - offx
    cy = labels[..., 2] * s + r[None, :, None] * s - offy
    w, h = labels[..., 3] * s, labels[..., 4] * s
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1).reshape(b, 9 * t, 4).clamp(0, s)
    wh_ok = ((boxes[..., 2] - boxes[..., 0]) > 2) & \
        ((boxes[..., 3] - boxes[..., 1]) > 2)
    return (crop, boxes, labels[..., 0].reshape(b, 9 * t),
            mask.reshape(b, 9 * t) & wh_ok)


def replicate_draws(b: int, gen: torch.Generator) -> torch.Tensor:
    """``replicate_labels``'s draws: (B, 4, 2) U(0, 1) for each replica's
    x and y placement."""
    return _uniform((b, 4, 2), 0.0, 1.0, gen)


def replicate_labels(img, boxes_xyxy, cls, mask, u: torch.Tensor):
    """Replicate the 4 smallest valid boxes, pixels and labels, to random
    positions (datasets.py:2000-2013 ``replicate``; fixed count, where the
    reference does n // 2): boxes ranked by (w + h) / 2 on integer
    coordinates, smallest first, stable; each source patch copied to
    ``(u * max(dim - box dim, 1))`` truncated, on the current image (a
    later copy may pick up an earlier replica, as the reference mutates in
    place).  img (B, H, W, C); boxes (B, N, 4); cls, mask (B, N); u
    (B, 4, 2) from ``replicate_draws``."""
    b, h, w, c = img.shape
    bi = torch.floor(boxes_xyxy).to(torch.int32).long()
    side = ((bi[..., 2] - bi[..., 0]) + (bi[..., 3] - bi[..., 1])) / 2.0
    order = torch.argsort(torch.where(mask, side.to(boxes_xyxy.dtype),
                                      torch.full_like(boxes_xyxy[..., 0],
                                                      float("inf"))),
                          dim=1, stable=True)
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    ib = torch.arange(b, device=img.device)[:, None, None]
    out = img
    new_boxes, new_cls, new_mask = [], [], []
    for i in range(4):
        src = order[:, i]
        x1b, y1b, x2b, y2b = torch.gather(
            bi, 1, src[:, None, None].expand(-1, 1, 4))[:, 0].unbind(-1)
        bw, bh = x2b - x1b, y2b - y1b
        x1a = (u[:, i, 0] * (w - bw).clamp_min(1)).to(torch.int32).long()
        y1a = (u[:, i, 1] * (h - bh).clamp_min(1)).to(torch.int32).long()
        m_src = torch.gather(mask, 1, src[:, None])[:, 0]
        # the image rolled by the displacement, selected in the destination
        dy, dx = (y1a - y1b)[:, None, None], (x1a - x1b)[:, None, None]
        shifted = out[ib, (ys - dy) % h, (xs - dx) % w]
        y1, x1 = y1a[:, None, None], x1a[:, None, None]
        in_dst = ((ys >= y1) & (ys < y1 + bh[:, None, None]) & (xs >= x1)
                  & (xs < x1 + bw[:, None, None]) & m_src[:, None, None])
        out = torch.where(in_dst[..., None], shifted, out)
        new_boxes.append(torch.stack([x1a, y1a, x1a + bw, y1a + bh],
                                     -1).to(boxes_xyxy.dtype))
        new_cls.append(torch.gather(cls, 1, src[:, None])[:, 0])
        new_mask.append(m_src)
    return out, (torch.cat([boxes_xyxy, torch.stack(new_boxes, 1)], 1),
                 torch.cat([cls, torch.stack(new_cls, 1)], 1),
                 torch.cat([mask, torch.stack(new_mask, 1)], 1))
