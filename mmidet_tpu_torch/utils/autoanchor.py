"""AutoAnchor: anchor-fit checking and k-means + genetic anchor evolution.

A copy of ``mmidet_tpu/utils/autoanchor.py`` (numpy and scipy, on the
host); reference ``utils/autoanchor.py:12-201`` —
``check_anchor_order`` (area-monotonic anchors per stride),
``check_anchors`` (BPR < 0.98 triggers refit), ``kmean_anchors`` (whitened
k-means seed + 1000-generation mutation on the best-possible-recall fitness).
Runs offline on host (numpy/scipy), exactly like the reference.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def check_anchor_order(anchors: np.ndarray, strides) -> np.ndarray:
    """Ensure anchor areas ascend with stride; flip if reversed
    (ref check_anchor_order)."""
    a = np.asarray(anchors, np.float64).reshape(len(strides), -1, 2)
    areas = a.prod(-1).mean(-1)
    da = areas[-1] - areas[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        logger.info("reversing anchor order")
        a = a[::-1]
    return a


def _wh_from_labels(labels: list[np.ndarray], shapes, img_size: int
                    ) -> np.ndarray:
    """Label wh in pixels at train scale (ref check_anchors's scale-jittered
    collection, without the jitter for determinism)."""
    whs = []
    for lab, (h0, w0) in zip(labels, shapes):
        if not len(lab):
            continue
        scale = img_size / max(h0, w0)
        whs.append(lab[:, 3:5] * np.asarray([w0, h0]) * scale)
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def anchor_fitness(k: np.ndarray, wh: np.ndarray, thr: float = 4.0):
    """(fitness, best-possible recall): ratio metric from the reference
    (min(w/aw, aw/w, h/ah, ah/h) per anchor, best over anchors)."""
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1.0 / r).min(2)   # (n, na)
    best = x.max(1)
    aat = (x > 1.0 / thr).sum(1).mean()
    bpr = (best > 1.0 / thr).mean()
    fit = (best * (best > 1.0 / thr)).mean()
    return fit, bpr, aat


def kmean_anchors(wh: np.ndarray, n: int = 9, img_size: int = 640,
                  thr: float = 4.0, gen: int = 1000,
                  seed: int = 0) -> np.ndarray:
    """k-means (whitened) + genetic evolution of anchors
    (ref kmean_anchors, utils/autoanchor.py:77-201)."""
    from scipy.cluster.vq import kmeans
    wh = wh[(wh >= 2.0).any(1)]  # filter tiny boxes (ref filters < 2px)
    if len(wh) < n:
        logger.warning("too few labels (%d) for %d anchors", len(wh), n)
        return None
    std = wh.std(0)
    k, _ = kmeans(wh / std, n, iter=30, seed=seed)
    k = k * std
    if len(k) != n:
        logger.warning("kmeans returned %d != %d clusters", len(k), n)
        return None

    rng = np.random.default_rng(seed)
    f, _, _ = anchor_fitness(k, wh, thr)
    shape = k.shape
    mp, s = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = ((rng.random(shape) < mp) * rng.random()
                 * rng.standard_normal(shape) * s + 1).clip(0.3, 3.0)
        kg = (k * v).clip(2.0)
        fg, _, _ = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
    return k[np.argsort(k.prod(1))]  # area-sorted


def check_anchors(labels: list[np.ndarray], shapes, anchors: np.ndarray,
                  strides, img_size: int = 640, thr: float = 4.0):
    """BPR gate + refit (ref check_anchors / check_anchors_rgb_ir).

    Returns possibly-updated anchors (nl, na, 2) in pixels."""
    anchors = np.asarray(anchors, np.float64).reshape(len(strides), -1, 2)
    wh = _wh_from_labels(labels, shapes, img_size)
    if not len(wh):
        return anchors
    _, bpr, aat = anchor_fitness(anchors.reshape(-1, 2), wh, thr)
    logger.info("anchors: %.2f anchors/target, %.3f best possible recall",
                aat, bpr)
    if bpr >= 0.98:
        return anchors
    logger.info("BPR < 0.98, re-fitting anchors with kmeans+GA")
    na = anchors.reshape(-1, 2).shape[0]
    new = kmean_anchors(wh, n=na, img_size=img_size, thr=thr)
    if new is None:
        return anchors
    # acceptance criterion is BPR, not fitness: the reference keeps the
    # original anchors unless the NEW best-possible-recall beats the old
    # ('Original anchors better than new anchors', autoanchor.py:51-53)
    _, new_bpr, _ = anchor_fitness(new, wh, thr)
    _, old_bpr, _ = anchor_fitness(anchors.reshape(-1, 2), wh, thr)
    if new_bpr > old_bpr:
        out = new.reshape(anchors.shape)
        return check_anchor_order(out, strides)
    logger.info("original anchors better than new anchors, keeping them")
    return anchors
