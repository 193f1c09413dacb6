"""Paired VIS-IR dataset: file discovery, YOLO-txt label loading + cache,
host-side decode and letterbox.

A copy of ``mmidet_tpu/data/datasets.py`` (the port imports nothing of the
JAX package); reference ``LoadMultiModalImagesAndLabels``
(``utils/datasets.py:1067-1602``): directory/list-file discovery per
modality, hash-validated label cache, paired ``__getitem__``, IR labels
aliased to RGB labels (``datasets.py:1497-1498,1908``).  The label cache
keeps the JAX package's file name and contents, so that one dataset
directory serves both packages alike.
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

IMG_FORMATS = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp",
               ".dng", ".mpo")  # full reference set (datasets.py:33-34)


def discover_images(path: str) -> list[str]:
    """Directory, glob, or list-file -> sorted image paths.
    Ref: datasets.py:1072-1100."""
    files: list[str] = []
    for p in (path if isinstance(path, (list, tuple)) else [path]):
        p = str(p)
        if os.path.isdir(p):
            files += glob.glob(os.path.join(p, "**", "*.*"), recursive=True)
        elif os.path.isfile(p) and p.endswith((".txt",)):
            root = os.path.dirname(p)
            with open(p) as fh:
                for line in fh.read().splitlines():
                    line = line.strip()
                    if line:
                        files.append(line if os.path.isabs(line)
                                     else os.path.join(root, line))
        elif os.path.isfile(p):
            files.append(p)
        else:
            raise FileNotFoundError(f"dataset path {p} does not exist")
    files = [f for f in files if os.path.splitext(f)[-1].lower()
             in IMG_FORMATS]
    return sorted(files)


def img2label_path(img_path: str) -> str:
    """modality-images dir -> labels/, suffix -> .txt (ref img2label_paths,
    datasets.py:708-735).  Real multispectral datasets (M3FD etc.) keep the
    modalities in sibling ``RGBimages/``/``IRimages/`` dirs that BOTH map to
    one shared ``labels/`` dir; plain ``images/`` covers the generic case."""
    sb = os.sep + "labels" + os.sep
    for tok in ("RGBimages", "IRimages", "FOGimages", "U2Fuseimages",
                "DenseFuseimages", "PIAFusionimages", "images"):
        sa = os.sep + tok + os.sep
        if sa in img_path:
            p = sb.join(img_path.rsplit(sa, 1))
            return os.path.splitext(p)[0] + ".txt"
    return os.path.splitext(img_path)[0] + ".txt"


def load_labels(label_path: str, nc: int | None = None) -> np.ndarray:
    """(M, 5) [cls, x, y, w, h] normalized; validates like the reference's
    cache_labels asserts (datasets.py:893-898)."""
    if not os.path.isfile(label_path):
        return np.zeros((0, 5), np.float32)
    with open(label_path) as fh:
        # filter on the SPLIT result: a whitespace-only line is truthy but
        # splits to [], which would make np.asarray ragged
        rows = [r for r in (line.split()
                            for line in fh.read().splitlines()) if r]
    if not rows:
        return np.zeros((0, 5), np.float32)
    if any(len(r) > 5 for r in rows):
        # segment labels: cls x1 y1 x2 y2 ... -> min/max box, as the
        # reference's cache_labels (datasets.py:885-891, segments2boxes /
        # segment2box, general.py:349-365); 5-field rows stay plain boxes
        out = []
        for r in rows:
            if len(r) == 5:
                out.append([float(v) for v in r])
                continue
            cls = float(r[0])
            pts = np.asarray(r[1:], np.float32).reshape(-1, 2)
            x0, y0 = pts.min(0)
            x1, y1 = pts.max(0)
            out.append([cls, (x0 + x1) / 2, (y0 + y1) / 2,
                        x1 - x0, y1 - y0])
        lab = np.asarray(out, np.float32)
    else:
        lab = np.asarray(rows, np.float32)
    assert lab.shape[1] == 5, f"labels require 5 columns: {label_path}"
    assert (lab >= 0).all(), f"negative labels: {label_path}"
    assert (lab[:, 1:] <= 1).all(), \
        f"non-normalized or out of bounds coordinates: {label_path}"
    if nc is not None:
        assert (lab[:, 0] < nc).all(), f"class id >= nc in {label_path}"
    return lab


def _cache_key(paths: list[str]) -> str:
    """Hash of image paths+sizes AND their label files' sizes, as the
    reference get_hash over label_files + img_files (datasets.py:85-87):
    an edited label file must invalidate the cache, not be served stale."""
    h = hashlib.sha1()
    for p in paths:
        h.update(p.encode())
        for f in (p, img2label_path(p)):
            try:
                h.update(str(os.path.getsize(f)).encode())
            except OSError:
                h.update(b"-")
    return h.hexdigest()


def load_labels_cached(img_paths: list[str], cache_path: str,
                       nc: int | None = None) -> list[np.ndarray]:
    """Label cache keyed by path+size hash (ref cache_labels,
    datasets.py:1214-1260; np.savez instead of torch.save)."""
    key = _cache_key(img_paths)
    if os.path.isfile(cache_path):
        try:
            z = np.load(cache_path, allow_pickle=True)
            if str(z["key"]) == key:
                return list(z["labels"])
        except Exception:
            pass
    labels = [load_labels(img2label_path(p), nc) for p in img_paths]
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez(cache_path, key=key,
             labels=np.asarray(labels, dtype=object))
    return labels


def letterbox_np(img: np.ndarray, new_shape: tuple[int, int] = (640, 640),
                 color: int = 114, scaleup: bool = True):
    """Aspect-preserving resize + pad (ref ``letterbox``, datasets.py:2016).
    Returns (out, ratio, (dw, dh))."""
    from PIL import Image
    h, w = img.shape[:2]
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = (new_shape[1] - nw) / 2, (new_shape[0] - nh) / 2
    if (w, h) != (nw, nh):
        img = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), color,
                  img.dtype)
    out[top:top + nh, left:left + nw] = img
    return out, r, (dw, dh)


class PairedDataset:
    """Paired RGB+IR detection dataset (host side).

    Yields dict(rgb, ir: HWC uint8 originals; labels (M,5) normalized;
    shapes).  Labels come from the RGB annotations for both modalities
    (reference aliasing quirk, datasets.py:1908).
    """

    def __init__(self, rgb_path: str, ir_path: str, nc: int | None = None,
                 cache_dir: str | None = None, cache_images: bool = False):
        # --cache-images (ref datasets.py:841-857): keep decoded arrays in
        # RAM after first access (the loaders also switch off the native
        # decode path so the cache is actually hit)
        self.cache_images = cache_images
        self._img_cache: dict[int, tuple] = {}
        self.rgb_files = discover_images(rgb_path)
        self.ir_files = discover_images(ir_path)
        assert len(self.rgb_files) == len(self.ir_files), (
            f"modality count mismatch: {len(self.rgb_files)} rgb vs "
            f"{len(self.ir_files)} ir")
        assert self.rgb_files, f"no images found under {rgb_path}"
        # cache file: named by a hash of the source path(s), so (a) list
        # paths work (dirname on a list crashed) and (b) train and val
        # datasets sharing one cache_dir don't overwrite each other's
        # cache on every construction (the reference keeps one .cache per
        # label dir, datasets.py:1163-1175)
        first = rgb_path[0] if isinstance(rgb_path, (list, tuple)) \
            else rgb_path
        base = cache_dir or (os.path.dirname(str(first)) or ".")
        tag = hashlib.sha1(repr(rgb_path).encode()).hexdigest()[:10]
        cache = os.path.join(base, f"labels_rgb.{tag}.cache.npz")
        self.labels = load_labels_cached(self.rgb_files, cache, nc)

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, i: int):
        if self.cache_images and i in self._img_cache:
            rgb, ir = self._img_cache[i]
        else:
            from PIL import Image
            rgb = np.asarray(Image.open(self.rgb_files[i]).convert("RGB"))
            ir = np.asarray(Image.open(self.ir_files[i]).convert("RGB"))
            if self.cache_images:
                self._img_cache[i] = (rgb, ir)
        assert rgb.shape[:2] == ir.shape[:2], \
            f"paired shape mismatch at index {i}"
        return {"rgb": rgb, "ir": ir, "labels": self.labels[i],
                "shape": rgb.shape[:2],
                "rgb_file": self.rgb_files[i],
                "ir_file": self.ir_files[i]}


def load_data_yaml(path: str) -> dict:
    """Dataset YAML, either two-stream (train_rgb/val_rgb/train_ir/val_ir,
    ref data/multispectral/*.yaml) or single-stream (train/val, ref
    data/coco.yaml-style).  Single-stream yamls are normalized onto the
    paired keys with the one modality aliased (so every loader path is
    shared) and marked ``single_stream: True``."""
    import yaml
    with open(path) as fh:
        d = yaml.safe_load(fh)
    if "train_rgb" not in d and "train" in d:
        d["train_rgb"] = d["train_ir"] = d["train"]
        d["val_rgb"] = d["val_ir"] = d.get("val", d["train"])
        d["single_stream"] = True
    for k in ("train_rgb", "train_ir", "val_rgb", "val_ir"):
        if k not in d:
            raise KeyError(f"dataset yaml missing {k}")
    return d


class SingleStreamDataset(PairedDataset):
    """Single-modality detection dataset (reference LoadImagesAndLabels,
    datasets.py:738-1064) — runs through the paired machinery with the one
    modality supplied twice, so every loader/augment path is shared."""

    def __init__(self, path: str, nc: int | None = None,
                 cache_dir: str | None = None):
        super().__init__(path, path, nc=nc, cache_dir=cache_dir)
