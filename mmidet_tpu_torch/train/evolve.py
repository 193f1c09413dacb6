"""Hyperparameter evolution: genetic mutation over the training hyp space.

A copy of ``mmidet_tpu/train/evolve.py`` (numpy on a
``np.random.Generator``, so that the same seed and history give the JAX
package's hyps to the bit); reference ``train.py:1050-1129``: the meta
dict of (mutation scale, low, high) per hyperparameter, fitness-weighted
parent selection from ``evolve.txt``, 80%-probability / 0.2-sigma
mutation, bounds clipping, and ``print_mutation``'s record.
"""

from __future__ import annotations

import os

import numpy as np

# (mutation scale, lower, upper) — reference meta table (train.py:1052-1079)
META = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
}


def mutate(hyp: dict, history: list[tuple[float, dict]],
           rng: np.random.Generator, parent: str = "single") -> dict:
    """One generation: select parent(s) weighted by fitness, mutate
    (80% prob, sigma 0.2), clip to bounds. Ref: train.py:1085-1108."""
    keys = [k for k in META if k in hyp]
    if history:
        hist = sorted(history, key=lambda t: -t[0])[:5]
        w = np.asarray([max(t[0], 1e-6) for t in hist])
        if parent == "single" or len(hist) == 1:
            pick = hist[rng.choice(len(hist), p=w / w.sum())][1]
            base = dict(pick)
        else:  # weighted combination
            base = {k: float(np.sum([t[1][k] * wi for t, wi in
                                     zip(hist, w)]) / w.sum())
                    for k in keys}
    else:
        base = dict(hyp)

    mp, s = 0.8, 0.2
    g = np.asarray([META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (g * (rng.random(len(keys)) < mp) * rng.standard_normal(
            len(keys)) * rng.random() * s + 1).clip(0.3, 3.0)
    out = dict(base)
    for k, vi in zip(keys, v):
        lo, hi = META[k][1], META[k][2]
        out[k] = float(np.clip(base[k] * vi, lo, hi))
    return out


def evolve(train_fn, base_hyp: dict, generations: int = 300,
           workdir: str = "runs/evolve", seed: int = 0):
    """Run the evolution loop: ``train_fn(hyp) -> fitness``.
    Persists (fitness, hyp) history to evolve.txt (ref print_mutation)."""
    import json
    os.makedirs(workdir, exist_ok=True)
    hist_path = os.path.join(workdir, "evolve.txt")
    history: list[tuple[float, dict]] = []
    if os.path.isfile(hist_path):
        with open(hist_path) as fh:
            for line in fh:
                rec = json.loads(line)
                history.append((rec["fitness"], rec["hyp"]))
    rng = np.random.default_rng(seed)
    for gen in range(generations):
        hyp = mutate(base_hyp, history, rng)
        fit = float(train_fn(hyp))
        history.append((fit, hyp))
        with open(hist_path, "a") as fh:
            fh.write(json.dumps({"gen": gen, "fitness": fit,
                                 "hyp": hyp}) + "\n")
    best = max(history, key=lambda t: t[0])
    return best
