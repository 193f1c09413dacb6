"""Plotting: the color palette, box drawing, the confusion-matrix plot,
the trainer's plots (train batches, label histograms, results curves), the
LR schedule and the evolution panels.

A copy of ``mmidet_tpu/utils/plots.py``; reference
``utils/plots.py:29-445``.  The matplotlib plots are optional: their
callers skip them where matplotlib is missing.
"""

from __future__ import annotations

import math
import os

import numpy as np


class Colors:
    """Ultralytics-style fixed palette (ref plots.py Colors)."""

    def __init__(self):
        hexs = ("FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A",
                "92CC17", "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF",
                "344593", "6473FF", "0018EC", "8438FF", "520085", "CB38FF",
                "FF95C8", "FF37C7")
        self.palette = [tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))
                        for h in hexs]
        self.n = len(self.palette)

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


def plot_one_box(box, img: np.ndarray, color=None, label: str | None = None,
                 line_thickness: int = 2) -> np.ndarray:
    """Draw one xyxy box (+ label) on an HWC uint8 image (PIL backend —
    the reference uses cv2; output is equivalent annotation)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    color = color or colors(0)
    h, w = img.shape[:2]
    # clamp to the canvas: partially off-image boxes (common for raw
    # low-conf predictions) otherwise produce inverted PIL rectangles
    x1, y1, x2, y2 = (int(v) for v in box)
    x1, x2 = sorted((max(0, min(x1, w - 1)), max(0, min(x2, w - 1))))
    y1, y2 = sorted((max(0, min(y1, h - 1)), max(0, min(y2, h - 1))))
    d.rectangle([x1, y1, x2, y2], outline=tuple(color),
                width=line_thickness)
    if label:
        tw = int(d.textlength(label))
        th = 11
        ty = max(y1 - th - 2, 0)
        d.rectangle([x1, ty, min(x1 + tw + 2, w - 1), max(y1, ty + 1)],
                    fill=tuple(color))
        d.text((x1 + 1, ty), label, fill=(255, 255, 255))
    return np.asarray(im)


def plot_confusion_matrix(matrix: np.ndarray, names, save_path: str):
    """Normalized confusion-matrix heatmap (ref plots via seaborn; plain
    matplotlib here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    arr = matrix / (matrix.sum(0, keepdims=True) + 1e-6)
    fig, ax = plt.subplots(figsize=(8, 7), tight_layout=True)
    im = ax.imshow(arr, cmap="Blues")
    ticks = list(names) + ["background"]
    ax.set_xticks(range(len(ticks)), ticks, rotation=90)
    ax.set_yticks(range(len(ticks)), ticks)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.colorbar(im)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_images(images: np.ndarray, targets: np.ndarray, mask: np.ndarray,
                path: str, max_subplots: int = 16, names=None):
    """Training-batch mosaic with boxes (ref plots.py plot_images).
    images: (B,H,W,3) float 0..1; targets: (B,T,5) normalized."""
    from PIL import Image
    bs, h, w, _ = images.shape
    ns = min(bs, max_subplots)
    grid = int(math.ceil(ns ** 0.5))
    canvas = np.full((grid * h, grid * w, 3), 255, np.uint8)
    for i in range(ns):
        gy, gx = divmod(i, grid)
        img = (np.clip(images[i], 0, 1) * 255).astype(np.uint8)
        for t in range(targets.shape[1]):
            if not mask[i, t]:
                continue
            cls, cx, cy, bw, bh = targets[i, t]
            box = [(cx - bw / 2) * w, (cy - bh / 2) * h,
                   (cx + bw / 2) * w, (cy + bh / 2) * h]
            label = names[int(cls)] if names else str(int(cls))
            img = plot_one_box(box, img, color=colors(int(cls)),
                               label=label)
        canvas[gy * h:(gy + 1) * h, gx * w:(gx + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(canvas).save(path)
    return path


def plot_results(results_file: str, save_path: str | None = None):
    """Parse results.txt lines into curves png (ref plots.py plot_results)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import re
    rows = []
    with open(results_file) as fh:
        for line in fh:
            nums = re.findall(r"[-+]?\d*\.?\d+", line)
            if len(nums) >= 8:
                rows.append([float(x) for x in nums[-7:]])
    if not rows:
        return None
    arr = np.asarray(rows)
    labels = ["box", "obj", "cls", "P", "R", "mAP50", "mAP"]
    fig, axes = plt.subplots(2, 4, figsize=(14, 6), tight_layout=True)
    for i, lab in enumerate(labels):
        ax = axes.flat[i]
        ax.plot(arr[:, i])
        ax.set_title(lab)
    save_path = save_path or os.path.join(
        os.path.dirname(results_file), "results.png")
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_labels(labels: list[np.ndarray], nc: int, save_dir: str):
    """Class/box histograms (ref plots.py plot_labels)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    cat = np.concatenate([l for l in labels if len(l)], 0) if labels else \
        np.zeros((0, 5))
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), tight_layout=True)
    axes[0].hist(cat[:, 0], bins=max(nc, 1))
    axes[0].set_title("classes")
    axes[1].scatter(cat[:, 1], cat[:, 2], s=2, alpha=0.3)
    axes[1].set_title("xy centers")
    axes[2].scatter(cat[:, 3], cat[:, 4], s=2, alpha=0.3)
    axes[2].set_title("wh")
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, "labels.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def lr_curve(sched, steps: int | None = None):
    """(steps, lrs) that ``plot_lr_schedule`` draws: the schedule at every
    ``max(steps // 500, 1)``-th step of the run."""
    from mmidet_tpu_torch.train.schedule import lr_schedule
    steps = steps or sched.epochs * sched.steps_per_epoch
    fn = lr_schedule(sched)
    xs = np.arange(steps)[:: max(steps // 500, 1)]
    return xs, [float(fn(x)) for x in xs]


def plot_lr_schedule(sched, save_path: str, steps: int | None = None):
    """LR curve over training (ref plots.py plot_lr_scheduler)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    xs, ys = lr_curve(sched, steps)
    fig, ax = plt.subplots(figsize=(7, 4), tight_layout=True)
    ax.plot(xs, ys)
    ax.set_xlabel("step")
    ax.set_ylabel("lr")
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_evolve(evolve_txt: str, save_path: str | None = None):
    """Fitness-vs-hyperparameter scatter panels (ref plots.py
    plot_evolution)."""
    import json

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    with open(evolve_txt) as fh:
        rows = [json.loads(l) for l in fh if l.strip()]
    if not rows:
        return None
    keys = sorted(rows[0]["hyp"].keys())[:25]
    fit = np.asarray([r["fitness"] for r in rows])
    cols = 5
    rws = (len(keys) + cols - 1) // cols
    fig, axes = plt.subplots(rws, cols, figsize=(3 * cols, 2.4 * rws),
                             tight_layout=True)
    for ax, k in zip(axes.flat, keys):
        ax.scatter([r["hyp"][k] for r in rows], fit, s=8, alpha=0.6)
        ax.set_title(k, fontsize=8)
    save_path = save_path or evolve_txt.replace(".txt", ".png")
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
