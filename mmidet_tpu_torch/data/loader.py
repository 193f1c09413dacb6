"""Batched loaders with fixed shapes and background prefetch.

Counterpart of ``mmidet_tpu/data/loader.py``; reference
``InfiniteDataLoader`` and the rect batching of ``utils/datasets.py``.
Batches are dicts of numpy arrays: images letterboxed to the train or eval
size (or to a rect batch's shape), labels padded to ``max_labels`` with a
validity mask; the mosaic loader's batches hold 4 letterboxed tiles a
sample.  A background thread decodes the next batches while the card runs
the current one.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from mmidet_tpu_torch.data import native
from mmidet_tpu_torch.data.datasets import PairedDataset, letterbox_np


def _load_image_scale(img: np.ndarray, img_size: int,
                      augment: bool) -> np.ndarray:
    """Stage-1 content resize: longest side -> ``img_size`` (up AND down;
    ref load_image / load_image_rgb_ir, datasets.py:1648-1654: INTER_AREA
    when shrinking at val time, INTER_LINEAR otherwise).  The reference
    ALWAYS applies this before letterboxing, so eval content is at
    img_size scale even when the rect batch canvas is larger."""
    h0, w0 = img.shape[:2]
    r = img_size / max(h0, w0)
    if r == 1:
        return img
    new_wh = (int(w0 * r), int(h0 * r))
    try:
        import cv2
        interp = cv2.INTER_AREA if (r < 1 and not augment) \
            else cv2.INTER_LINEAR
        return cv2.resize(img, new_wh, interpolation=interp)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize(new_wh,
                                                      Image.BILINEAR))


def collate_paired(samples: list[dict], img_size: int = 640,
                   max_labels: int = 120, shape_hw=None,
                   scaleup: bool = True) -> dict:
    """Two-stage resize as the reference eval pipeline
    (datasets.py:1478-1496): (1) content to ``img_size`` scale
    (``_load_image_scale``), (2) letterbox pad into the batch canvas,
    square ``img_size`` or the rect ``shape_hw``.  Labels scaled to the
    padded frame; padded to (B, max_labels, 5) + mask.  ``scaleup=False``
    is the reference's VAL-time letterbox (datasets.py:1484-1487).

    ``shapes`` carries the reference's rescaling convention
    ((h0, w0), (gain, pad)): the stage-1 ratio with any further letterbox
    ratio folded in."""
    bsz = len(samples)
    th, tw = shape_hw if shape_hw is not None else (img_size, img_size)
    rgb = np.empty((bsz, th, tw, 3), np.uint8)
    ir = np.empty((bsz, th, tw, 3), np.uint8)
    targets = np.zeros((bsz, max_labels, 5), np.float32)
    mask = np.zeros((bsz, max_labels), bool)
    shapes = []
    for i, s in enumerate(samples):
        h0, w0 = s["shape"]
        im_r = _load_image_scale(s["rgb"], img_size, augment=scaleup)
        im_i = _load_image_scale(s["ir"], img_size, augment=scaleup)
        h1 = im_r.shape[0]
        out_r, r2, (dw, dh) = letterbox_np(im_r, (th, tw), scaleup=scaleup)
        out_i, _, _ = letterbox_np(im_i, (th, tw), scaleup=scaleup)
        rgb[i], ir[i] = out_r, out_i
        lab = s["labels"]
        n = min(len(lab), max_labels)
        if n:
            l = lab[:n].copy()
            # normalized in the original frame -> normalized in the padded
            # frame, on the ROUNDED content extents letterbox produced
            nw, nh = tw - 2.0 * dw, th - 2.0 * dh
            l[:, 1] = (l[:, 1] * nw + dw) / tw
            l[:, 2] = (l[:, 2] * nh + dh) / th
            l[:, 3] = l[:, 3] * nw / tw
            l[:, 4] = l[:, 4] * nh / th
            targets[i, :n] = l
            mask[i, :n] = True
        shapes.append((s["shape"], (h1 * r2 / h0, (dw, dh))))
    return {"rgb": rgb, "ir": ir, "targets": targets, "mask": mask,
            "shapes": shapes,
            "files": [s.get("rgb_file", "") for s in samples]}


def _mosaic_pool(bsz: int, s: int, max_labels_tile: int, tiles, metas,
                 labels) -> dict:
    """The mosaic pool batch from its (4B) tiles per modality, their
    letterbox (dw, dh) and their labels, in group order."""
    labels4 = np.zeros((bsz, 4, max_labels_tile, 5), np.float32)
    mask4 = np.zeros((bsz, 4, max_labels_tile), bool)
    # [top, left, nh, nw] content placement inside each letterboxed tile:
    # the card's mosaic anchors CONTENT corners at the centre, as the
    # reference's aspect-shaped placement (datasets.py:1780-1795)
    pads4 = np.zeros((bsz, 4, 4), np.float32)
    for k, ((dw, dh), lab) in enumerate(zip(metas, labels)):
        b, t = divmod(k, 4)
        pads4[b, t] = (int(round(dh - 0.1)), int(round(dw - 0.1)),
                       int(round(s - 2 * dh)), int(round(s - 2 * dw)))
        n = min(len(lab), max_labels_tile)
        if n:
            # normalized in the original frame -> normalized in the tile's
            # letterboxed square, on the ROUNDED content extents
            l = lab[:n].copy()
            nw, nh = s - 2.0 * dw, s - 2.0 * dh
            l[:, 1] = (l[:, 1] * nw + dw) / s
            l[:, 2] = (l[:, 2] * nh + dh) / s
            l[:, 3] = l[:, 3] * nw / s
            l[:, 4] = l[:, 4] * nh / s
            labels4[b, t, :n] = l
            mask4[b, t, :n] = True
    rgb, ir = tiles
    return {"rgb4": rgb.reshape(bsz, 4, s, s, 3),
            "ir4": ir.reshape(bsz, 4, s, s, 3), "labels4": labels4,
            "mask4": mask4, "pads4": pads4}


def collate_mosaic_pool(samples4: list[list[dict]], img_size: int,
                        max_labels_tile: int = 60) -> dict:
    """Collate B groups of 4 samples into the mosaic augmentation's input:
    rgb4/ir4 (B, 4, s, s, 3) uint8 letterboxed tiles, labels4 (B, 4, T, 5),
    mask4 (B, 4, T) and pads4 (B, 4, 4) (the reference picks self + 3
    random images, datasets.py:1764)."""
    s, flat = img_size, [smp for g in samples4 for smp in g]
    rgb = np.empty((len(flat), s, s, 3), np.uint8)
    ir = np.empty((len(flat), s, s, 3), np.uint8)
    metas = []
    for k, smp in enumerate(flat):
        rgb[k], _, pad = letterbox_np(smp["rgb"], (s, s))
        ir[k] = letterbox_np(smp["ir"], (s, s))[0]
        metas.append(pad)
    return _mosaic_pool(len(samples4), s, max_labels_tile, (rgb, ir), metas,
                        [smp["labels"] for smp in flat])


def collate_mosaic_pool_native(ds: PairedDataset, groups_idx, img_size: int,
                               max_labels_tile: int = 60) -> dict:
    """The native fastloader's mosaic collate: ONE C call decodes and
    letterboxes all 4B tiles per modality; the label geometry comes from
    the returned (r, dw, dh), the numbers ``collate_mosaic_pool``
    computes."""
    s = img_size
    flat = [j for g in groups_idx for j in g]
    rgb, meta = native.batch_decode_letterbox([ds.rgb_files[j] for j in flat],
                                              s)
    ir, _ = native.batch_decode_letterbox([ds.ir_files[j] for j in flat], s)
    return _mosaic_pool(len(groups_idx), s, max_labels_tile, (rgb, ir),
                        [(dw, dh) for _, dw, dh in meta],
                        [ds.labels[j] for j in flat])


def _prefetched(make_batches, depth: int):
    """Yield what ``make_batches()`` yields, produced ``depth`` ahead on a
    background thread; an exception there is raised here.  The thread is
    joined when the iteration ends or is abandoned."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in make_batches():
                if stop.is_set():
                    return
                q.put(item)
            q.put(None)
        except BaseException as e:  # propagate instead of deadlocking
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.01)


def _own_rows(sel, rows: slice | None, batch_size: int):
    """A data-parallel rank's ``rows`` of a full batch ``sel`` (and True);
    a ragged batch whole (and False)."""
    if rows is not None and len(sel) == batch_size:
        return sel[rows], True
    return sel, False


def _marked(batch: dict, rows: slice | None, split: bool) -> dict:
    if rows is not None:
        batch["split"] = split
    return batch


class MosaicLoader:
    """Training loader of mosaic pool batches (4 tiles a sample: the
    indexed image + 3 uniformly random ones, as the reference).  An epoch's
    order and companions come from ``np.random.default_rng(seed +
    epoch)``: the permutation, then 3 companions a sample drawn batch by
    batch, as the JAX package's loader draws them.

    ``use_native``: decode through the C++ fastloader (one call per batch
    and modality); None (default) takes it when it is available and the
    dataset does not cache images.  ``set_image_weights`` (the trainer's
    ``image_weights``): later epochs draw their base indices ``n`` times
    from the weights, ``rng.choice(n, n, p=w)`` in place of the
    permutation; the companions stay uniform.

    ``rows`` (a slice; the data-parallel trainer's ``batch_rows``): each
    full batch is drawn whole and only these rows are decoded, the batch
    marked ``split``; this holds for ``RectLoader`` and ``PairedLoader``
    too, whose ragged final batch comes whole, ``split`` False."""

    rows: slice | None = None

    def __init__(self, dataset: PairedDataset, batch_size: int,
                 img_size: int = 640, max_labels_tile: int = 60,
                 seed: int = 0, prefetch: int = 2,
                 use_native: bool | None = None):
        if use_native is None:
            use_native = (native.available()
                          and not getattr(dataset, "cache_images", False))
        self.use_native = use_native
        self.ds = dataset
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_labels_tile = max_labels_tile
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.image_weights = None  # optional (N,) sampling weights

    def __len__(self):
        return len(self.ds) // self.batch_size

    def set_image_weights(self, weights):
        """Per-image sampling weights (reference --image-weights,
        train.py:715-727): the next epochs resample base indices ~ weights."""
        w = np.asarray(weights, np.float64)
        self.image_weights = w / w.sum()

    def _indices(self, rng):
        if self.image_weights is not None:
            return rng.choice(len(self.ds), size=len(self.ds),
                              p=self.image_weights)
        return rng.permutation(len(self.ds))

    def _batches(self, rng, idx):
        n = len(self.ds)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            # companions sample UNIFORMLY under image weights too: the
            # reference draws them from range(n) (datasets.py:1223, 1794)
            groups = [[int(i)] + [int(x) for x in rng.integers(0, n, 3)]
                      for i in sel]
            groups, split = _own_rows(groups, self.rows, self.batch_size)
            if self.use_native:
                out = collate_mosaic_pool_native(
                    self.ds, groups, self.img_size, self.max_labels_tile)
            else:
                out = collate_mosaic_pool(
                    [[self.ds[j] for j in g] for g in groups],
                    self.img_size, self.max_labels_tile)
            yield _marked(out, self.rows, split)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        idx = self._indices(rng)
        return _prefetched(lambda: self._batches(rng, idx), self.prefetch)


class RectLoader:
    """Aspect-bucketed evaluation loader (reference ``rect=True, pad=0.5``,
    datasets.py:1160-1190): images sorted by aspect ratio; each batch gets a
    stride-aligned rectangular shape covering its members, minimizing pad
    pixels.  Decodes with PIL (``use_native`` is False: the native leg
    letterboxes to squares only)."""

    use_native = False
    rows: slice | None = None

    def __init__(self, dataset: PairedDataset, batch_size: int,
                 img_size: int = 640, max_labels: int = 120,
                 stride: int = 32, pad: float = 0.5,
                 scaleup: bool = False):
        # scaleup=False is the reference EVAL default (letterbox
        # scaleup=self.augment); rect-TRAIN passes True
        self.scaleup = scaleup
        self.ds = dataset
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_labels = max_labels
        from PIL import Image
        ars = []
        for p in dataset.rgb_files:
            with Image.open(p) as im:
                w, h = im.size
            ars.append(h / w)
        self.order = np.argsort(ars)
        self.shapes = []
        n = len(dataset)
        nb = (n + batch_size - 1) // batch_size
        for b in range(nb):
            sel = self.order[b * batch_size:(b + 1) * batch_size]
            batch_ars = [ars[i] for i in sel]
            mi, ma = min(batch_ars), max(batch_ars)
            shape = [1.0, 1.0]
            if ma < 1:
                shape = [ma, 1.0]
            elif mi > 1:
                shape = [1.0, 1.0 / mi]
            th = int(np.ceil(shape[0] * img_size / stride + pad)) * stride
            tw = int(np.ceil(shape[1] * img_size / stride + pad)) * stride
            self.shapes.append((min(th, img_size + stride),
                                min(tw, img_size + stride)))

    def __len__(self):
        return len(self.shapes)

    def __iter__(self):
        for b, shape_hw in enumerate(self.shapes):
            sel = self.order[b * self.batch_size:(b + 1) * self.batch_size]
            sel, split = _own_rows(sel, self.rows, self.batch_size)
            samples = [self.ds[int(i)] for i in sel]
            yield _marked(collate_paired(
                samples, self.img_size, self.max_labels, shape_hw=shape_hw,
                scaleup=self.scaleup), self.rows, split)


class PairedLoader:
    """Iterates collated batches; optional shuffle; drops the last partial
    batch unless ``drop_last=False`` (evaluation).

    ``use_native``: decode and letterbox through the C++ fastloader (one
    call per batch and modality); None (default) takes it when it is
    available and the dataset does not cache images, as the JAX package
    does.  ``loader.use_native`` tells which leg was taken.
    ``set_image_weights`` and ``rows``: as ``MosaicLoader``'s."""

    rows: slice | None = None

    def __init__(self, dataset: PairedDataset, batch_size: int,
                 img_size: int = 640, max_labels: int = 120,
                 shuffle: bool = False, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 use_native: bool | None = None, scaleup: bool = True):
        if use_native is None:
            use_native = (native.available()
                          and not getattr(dataset, "cache_images", False))
        self.use_native = use_native
        self.scaleup = scaleup  # False = reference val-time letterbox
        self.ds = dataset
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_labels = max_labels
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.image_weights = None  # optional (N,) sampling weights

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def set_image_weights(self, weights):
        """Per-image sampling weights (reference --image-weights,
        train.py:715-727): the next epochs resample indices ~ weights."""
        w = np.asarray(weights, np.float64)
        self.image_weights = w / w.sum()

    def _indices(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.image_weights is not None:
            return rng.choice(len(self.ds), size=len(self.ds),
                              p=self.image_weights)
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def _collate_native(self, sel):
        """Batch decode+letterbox both modalities in one native call each."""
        from PIL import Image
        rgb_paths = [self.ds.rgb_files[int(i)] for i in sel]
        ir_paths = [self.ds.ir_files[int(i)] for i in sel]
        rgb, meta = native.batch_decode_letterbox(rgb_paths, self.img_size,
                                                  scaleup=self.scaleup)
        ir, _ = native.batch_decode_letterbox(ir_paths, self.img_size,
                                              scaleup=self.scaleup)
        bsz = len(sel)
        targets = np.zeros((bsz, self.max_labels, 5), np.float32)
        mask = np.zeros((bsz, self.max_labels), bool)
        shapes = []
        s_ = self.img_size
        for i, ds_i in enumerate(sel):
            lab = self.ds.labels[int(ds_i)]
            r, dw, dh = meta[i]
            # recover the original shape from the image header
            with Image.open(rgb_paths[i]) as im:
                w0, h0 = im.size
            n = min(len(lab), self.max_labels)
            if n:
                l = lab[:n].copy()
                l[:, 1] = (l[:, 1] * w0 * r + dw) / s_
                l[:, 2] = (l[:, 2] * h0 * r + dh) / s_
                l[:, 3] = l[:, 3] * w0 * r / s_
                l[:, 4] = l[:, 4] * h0 * r / s_
                targets[i, :n] = l
                mask[i, :n] = True
            shapes.append(((h0, w0), (r, (dw, dh))))
        return {"rgb": rgb, "ir": ir, "targets": targets, "mask": mask,
                "shapes": shapes, "files": rgb_paths}

    def _batches(self, idx):
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            sel, split = _own_rows(sel, self.rows, self.batch_size)
            if self.use_native:
                out = self._collate_native(sel)
            else:
                samples = [self.ds[int(i)] for i in sel]
                out = collate_paired(samples, self.img_size, self.max_labels,
                                     scaleup=self.scaleup)
            yield _marked(out, self.rows, split)

    def __iter__(self):
        idx = self._indices()
        self.epoch += 1
        return _prefetched(lambda: self._batches(idx), self.prefetch)
