"""General utilities of the CLIs and the trainer.

A copy of ``mmidet_tpu/utils/general.py``; reference ``utils/general.py``:
run-dir management, size checks, colored logging, class and image weights
(``--image-weights``), detection crops, the second-stage classifier and
the ``--bucket`` upload.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import re

import numpy as np


def set_logging(rank: int = -1):
    logging.basicConfig(
        format="%(message)s",
        level=logging.INFO if rank in (-1, 0) else logging.WARN)


def colorstr(*input):
    """colorstr('blue', 'hello world') — ANSI colored string
    (ref general.py colorstr)."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m",
        "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m"}
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def check_img_size(img_size: int, s: int = 32) -> int:
    """Round img size up to a stride multiple (ref check_img_size)."""
    new = int(math.ceil(img_size / s) * s)
    if new != img_size:
        logging.warning("img size %d must be a multiple of %d, using %d",
                        img_size, s, new)
    return new


def increment_path(path: str, exist_ok: bool = False, sep: str = "") -> str:
    """runs/exp -> runs/exp{sep}2, runs/exp{sep}3, ... (ref increment_path)."""
    if exist_ok or not os.path.exists(path):
        return path
    dirs = glob.glob(f"{path}{sep}*")
    matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path), d)
               for d in dirs]
    i = [int(m.groups()[0]) for m in matches if m]
    n = max(i) + 1 if i else 2
    return f"{path}{sep}{n}"


def get_latest_run(search_dir: str = ".") -> str:
    """The most recent run dir under ``search_dir``: a workdir holding a
    ``ckpt/`` (ref get_latest_run, general.py:51-54, which globs
    last.pt).  Returns the RUN dir, "" when there is none."""
    ckpts = [c for c in glob.glob(f"{search_dir}/**/ckpt", recursive=True)
             if os.path.isdir(c)]
    return os.path.dirname(max(ckpts, key=os.path.getctime)) if ckpts else ""


def labels_to_class_weights(labels: list[np.ndarray], nc: int) -> np.ndarray:
    """Inverse-frequency class weights (ref labels_to_class_weights)."""
    if not labels:
        return np.ones(nc)
    classes = np.concatenate([l[:, 0] for l in labels if len(l)]
                             or [np.zeros(0)]).astype(int)
    counts = np.bincount(classes, minlength=nc).astype(float)
    counts[counts == 0] = 1
    weights = 1.0 / counts
    return weights / weights.sum()


def labels_to_image_weights(labels: list[np.ndarray], nc: int,
                            class_weights: np.ndarray) -> np.ndarray:
    """Per-image sampling weights from class weights
    (ref labels_to_image_weights)."""
    class_counts = np.array(
        [np.bincount(l[:, 0].astype(int), minlength=nc) if len(l)
         else np.zeros(nc) for l in labels])
    return (class_weights.reshape(1, nc) * class_counts).sum(1)


def save_one_box(xyxy, img: np.ndarray, path: str = "crop.jpg",
                 gain: float = 1.02, pad: int = 10, square: bool = False,
                 save: bool = True) -> np.ndarray:
    """Crop a detection box (with margin) from an HWC image and optionally
    save it (ref general.py save_one_box)."""
    from PIL import Image
    x1, y1, x2, y2 = [float(v) for v in xyxy]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w, h = (x2 - x1) * gain + pad, (y2 - y1) * gain + pad
    if square:
        w = h = max(w, h)
    H, W = img.shape[:2]
    xa, xb = int(max(cx - w / 2, 0)), int(min(cx + w / 2, W))
    ya, yb = int(max(cy - h / 2, 0)), int(min(cy + h / 2, H))
    crop = img[ya:yb, xa:xb]
    if save and crop.size:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Image.fromarray(crop).save(path)
    return crop


def apply_classifier(detections: np.ndarray, classify_fn, img: np.ndarray,
                     img_size: int = 224) -> np.ndarray:
    """Second-stage classifier filter: re-classify each detection crop and
    drop detections whose classifier label disagrees (ref general.py
    apply_classifier, over any ``classify_fn(batch) -> labels``)."""
    if not len(detections):
        return detections
    from PIL import Image
    crops = []
    for *xyxy, conf, cls in detections:
        crop = save_one_box(xyxy, img, save=False)
        if not crop.size:
            crop = np.zeros((8, 8, 3), np.uint8)
        crop = np.asarray(Image.fromarray(crop).resize(
            (img_size, img_size), Image.BILINEAR), np.float32) / 255.0
        crops.append(crop)
    labels = np.asarray(classify_fn(np.stack(crops)))
    keep = labels == detections[:, 5].astype(labels.dtype)
    return detections[keep]


def gsutil_upload(bucket: str, *paths: str) -> bool:
    """Best-effort ``gsutil cp <paths> gs://<bucket>/`` (reference
    ``--bucket`` uploads, train.py:860-861).  Returns False when gsutil is
    not on ``PATH`` or the copy fails."""
    import shutil
    import subprocess
    if not bucket or shutil.which("gsutil") is None:
        return False
    dest = bucket if bucket.startswith("gs://") else f"gs://{bucket}"
    try:
        return subprocess.run(
            ["gsutil", "cp", *[str(p) for p in paths], dest.rstrip("/") + "/"],
            capture_output=True, timeout=300).returncode == 0
    except Exception:
        return False
