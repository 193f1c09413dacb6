"""Plotting: the color palette, box drawing and the confusion-matrix plot.

A copy of the parts of ``mmidet_tpu/utils/plots.py`` that the port's
evaluator and CLIs use; reference ``utils/plots.py:29-445``.
"""

from __future__ import annotations

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
