"""Tiny synthetic paired VIS-IR dataset generator for tests and smoke runs.

A copy of ``mmidet_tpu/data/synthetic.py``: the same seed writes the same
bytes.  The on-disk layout is the M3FD one the reference consumes
(``data/multispectral/M3FD_8_2.yaml``: ``{split}_rgb/ {split}_ir/`` image
dirs + sibling ``labels`` dirs with YOLO-format txt files).  Images hold
bright rectangles (class 0) and ellipses (class 1); the IR view is a
grayscale-ish transform of the same geometry.
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_pair_dataset(root: str, n: int = 8, img: int = 160,
                                seed: int = 0, split: str = "train"):
    """Writes {root}/{split}_rgb/images, {split}_ir/images + labels dirs and
    a dataset YAML; returns the YAML path."""
    rng = np.random.default_rng(seed)
    from PIL import Image

    rgb_dir = os.path.join(root, f"{split}_rgb", "images")
    ir_dir = os.path.join(root, f"{split}_ir", "images")
    rgb_lbl = os.path.join(root, f"{split}_rgb", "labels")
    ir_lbl = os.path.join(root, f"{split}_ir", "labels")
    for d in (rgb_dir, ir_dir, rgb_lbl, ir_lbl):
        os.makedirs(d, exist_ok=True)

    for i in range(n):
        canvas = rng.integers(10, 60, (img, img, 3), np.uint8)
        labels = []
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, 2))
            w = int(rng.integers(img // 8, img // 3))
            h = int(rng.integers(img // 8, img // 3))
            x0 = int(rng.integers(0, img - w))
            y0 = int(rng.integers(0, img - h))
            color = rng.integers(150, 255, 3)
            if cls == 0:
                canvas[y0:y0 + h, x0:x0 + w] = color
            else:
                yy, xx = np.mgrid[0:img, 0:img]
                cx, cy = x0 + w / 2, y0 + h / 2
                m = (((xx - cx) / (w / 2)) ** 2
                     + ((yy - cy) / (h / 2)) ** 2) <= 1
                canvas[m] = color
            labels.append((cls, (x0 + w / 2) / img, (y0 + h / 2) / img,
                           w / img, h / img))
        name = f"{split}_{i:04d}"
        Image.fromarray(canvas).save(os.path.join(rgb_dir, name + ".png"))
        ir = (canvas.astype(np.float32).mean(-1, keepdims=True)
              * np.asarray([1.0, 0.9, 0.8])).clip(0, 255).astype(np.uint8)
        Image.fromarray(ir).save(os.path.join(ir_dir, name + ".png"))
        txt = "\n".join("%d %.6f %.6f %.6f %.6f" % l for l in labels)
        for d in (rgb_lbl, ir_lbl):
            with open(os.path.join(d, name + ".txt"), "w") as fh:
                fh.write(txt + "\n")

    # compose the YAML from whatever splits exist under root: a later
    # `split="val"` call upgrades the val entries instead of repointing
    # train at the val dirs (each split call rewrites the same yaml)
    def _dirs(split_name):
        r = os.path.join(root, f"{split_name}_rgb", "images")
        i = os.path.join(root, f"{split_name}_ir", "images")
        return (r, i) if os.path.isdir(r) else (rgb_dir, ir_dir)

    tr_rgb, tr_ir = _dirs("train")
    va_rgb, va_ir = _dirs("val")
    yaml_path = os.path.join(root, "synthetic.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(
            f"train_rgb: {tr_rgb}\n"
            f"train_ir: {tr_ir}\n"
            f"val_rgb: {va_rgb}\n"
            f"val_ir: {va_ir}\n"
            "nc: 2\n"
            "names: ['box', 'blob']\n")
    return yaml_path
