"""Hub-style model constructors and an input-robust inference wrapper.

Counterpart of ``mmidet_tpu/hub.py``; reference ``hubconf.py:21-143``
(``yolov5s`` .. ``yolov5x6``, ``custom``) and ``autoShape`` /
``Detections`` (``models/common.py:951-1129``): pass a filename, a PIL
image, an HWC or CHW array, or a list of them, get a ``Detections`` with
records, render, save and crop helpers.

    from mmidet_tpu_torch import hub
    m = hub.mmidet(nc=6)                      # the flagship, on the card
    dets = m(rgb_images, ir_images)
    dets.pandas()                             # records per image

The models are the deploy form on the card (BN folded, bf16, the kernel
routes of ``cli.val.kernel_routes``); ``device="cpu"`` runs the plain
routes in f32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mmidet_tpu_torch.data.datasets import letterbox_np
from mmidet_tpu_torch.eval.evaluator import eval_device
from mmidet_tpu_torch.models.spec import is_two_stream
from mmidet_tpu_torch.models.tta import forward_tta
from mmidet_tpu_torch.ops.nms import non_max_suppression


class Detections:
    """Inference results (ref ``Detections``, common.py:1032-1129)."""

    def __init__(self, imgs, records, names):
        self.imgs = imgs
        self.records = records  # per image, a list of dicts
        self.names = names

    @property
    def n(self):
        return len(self.imgs)

    def pandas(self):
        """Per-image record lists (the 'records' orient, no pandas)."""
        return self.records

    def render(self):
        from mmidet_tpu_torch.utils.plots import colors, plot_one_box
        out = []
        for img, recs in zip(self.imgs, self.records):
            ann = img.copy()
            for r in recs:
                ann = plot_one_box(
                    [r["xmin"], r["ymin"], r["xmax"], r["ymax"]], ann,
                    colors(r["class"]), f"{r['name']} {r['confidence']:.2f}")
            out.append(ann)
        return out

    def save(self, save_dir="runs/hub"):
        from PIL import Image
        os.makedirs(save_dir, exist_ok=True)
        paths = []
        for i, ann in enumerate(self.render()):
            p = os.path.join(save_dir, f"image{i}.jpg")
            Image.fromarray(ann).save(p)
            paths.append(p)
        return paths

    def crop(self, save_dir="runs/hub/crops", save=True):
        """Per-detection crops (ref ``Detections.crop``,
        common.py:1100-1108); written under <save_dir>/<class>/ when
        ``save``."""
        from mmidet_tpu_torch.utils.general import save_one_box
        crops = []
        for i, (img, recs) in enumerate(zip(self.imgs, self.records)):
            for k, r in enumerate(recs):
                path = os.path.join(save_dir, r["name"], f"image{i}_{k}.jpg")
                crops.append(save_one_box(
                    [r["xmin"], r["ymin"], r["xmax"], r["ymax"]], img,
                    path, save=save))
        return crops

    def tolist(self):
        """One ``Detections`` per image (ref ``Detections.tolist``)."""
        return [Detections([img], [recs], self.names)
                for img, recs in zip(self.imgs, self.records)]

    def print(self):
        print(self.__repr__())

    def __repr__(self):
        return (f"Detections({self.n} images, "
                f"{sum(len(r) for r in self.records)} objects)")


class AutoShapeModel:
    """Input-robust wrapper: filename | PIL | numpy HWC or CHW | a list ->
    letterbox -> forward (TTA with ``augment``) -> NMS -> detections in
    the original images' coordinates (ref ``autoShape``).  ``conf``,
    ``iou`` and ``augment`` are read at each call.  The default device is
    the card; without CUDA the constructor raises unless
    ``device="cpu"``."""

    def __init__(self, model: torch.nn.Module, names, img_size: int = 640,
                 conf: float = 0.25, iou: float = 0.45,
                 two_stream: bool = False, augment: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = eval_device(device)
        self.model = model.to(self.device).eval()
        self.names = names
        self.img_size = img_size
        self.conf = conf
        self.iou = iou
        self.two_stream = two_stream
        self.augment = augment  # TTA (ref autoShape.forward(augment=...))

    @torch.inference_mode()
    def _infer(self, *imgs):
        def fwd(*ims):
            return self.model(*ims)["pred"]
        if self.augment:
            pred = forward_tta(fwd, imgs[0],
                               imgs[1] if self.two_stream else None,
                               gs=int(max(self.model.spec.strides)))
        else:
            pred = fwd(*imgs)
        dets, valid = non_max_suppression(pred.float(),
                                          conf_thres=float(self.conf),
                                          iou_thres=float(self.iou))
        return dets.cpu().numpy(), valid.cpu().numpy()

    @staticmethod
    def _to_numpy(im):
        from PIL import Image
        if isinstance(im, str):
            return np.asarray(Image.open(im).convert("RGB"))
        if hasattr(im, "convert"):  # PIL
            return np.asarray(im.convert("RGB"))
        im = np.asarray(im)
        if im.ndim == 3 and im.shape[0] in (1, 3) and \
                im.shape[0] < im.shape[-1]:
            im = im.transpose(1, 2, 0)  # CHW -> HWC
        if im.ndim == 2:
            im = np.tile(im[..., None], 3)
        return im[..., :3]

    def __call__(self, imgs, imgs2=None):
        single = not isinstance(imgs, (list, tuple))
        imgs = [imgs] if single else list(imgs)
        imgs = [self._to_numpy(im) for im in imgs]
        if self.two_stream:
            imgs2 = [imgs2] if not isinstance(imgs2, (list, tuple)) else \
                list(imgs2)
            imgs2 = [self._to_numpy(im) for im in imgs2]
        else:
            imgs2 = imgs

        s = self.img_size
        lb, lb2, meta = [], [], []
        for im, im2 in zip(imgs, imgs2):
            out, r, (dw, dh) = letterbox_np(im, (s, s))
            lb.append(out)
            lb2.append(letterbox_np(im2, (s, s))[0])
            meta.append((r, dw, dh, im.shape[:2]))

        def batch(arrs):
            return torch.from_numpy(np.stack(arrs)).to(
                self.device).float() / 255.0
        args = (batch(lb), batch(lb2)) if self.two_stream else (batch(lb),)
        dets, valid = self._infer(*args)
        records = []
        for i, (r, dw, dh, (h0, w0)) in enumerate(meta):
            recs = []
            for x1, y1, x2, y2, conf, cls in dets[i][valid[i]]:
                recs.append({
                    "xmin": float(np.clip((x1 - dw) / r, 0, w0)),
                    "ymin": float(np.clip((y1 - dh) / r, 0, h0)),
                    "xmax": float(np.clip((x2 - dw) / r, 0, w0)),
                    "ymax": float(np.clip((y2 - dh) / r, 0, h0)),
                    "confidence": float(conf), "class": int(cls),
                    "name": self.names[int(cls)]})
            records.append(recs)
        return Detections(imgs, records, self.names)


def _wrap(spec, sd, names, img_size: int, conf: float, iou: float,
          augment: bool, device, dtype=None):
    """``AutoShapeModel`` over the deploy form of ``spec`` with ``sd``
    (None: the seeded init); the CEM where the spec is two-stream."""
    from mmidet_tpu_torch.cli.val import deploy_model
    dev = eval_device(device)
    two_stream = is_two_stream(spec)
    model = deploy_model(spec, sd, use_cem=two_stream, dev=dev, dtype=dtype)
    names = names or [str(i) for i in range(spec.nc)]
    return AutoShapeModel(model, names, img_size, conf=conf, iou=iou,
                          two_stream=two_stream, augment=augment,
                          device=dev)


def _make(name: str, nc: int = 80, weights: str = "", names=None,
          img_size: int = 640, conf: float = 0.25, iou: float = 0.45,
          augment: bool = False, device="cuda", dtype=None):
    from mmidet_tpu_torch.cli.val import load_state_dict_file
    from mmidet_tpu_torch.models.zoo import get_model_spec
    sd = load_state_dict_file(weights) if weights else None
    return _wrap(get_model_spec(name, nc=nc), sd, names, img_size, conf,
                 iou, augment, device, dtype)


def yolov5s(nc: int = 80, **kw):
    return _make("yolov5s", nc, **kw)


def yolov5m(nc: int = 80, **kw):
    return _make("yolov5m", nc, **kw)


def yolov5l(nc: int = 80, **kw):
    return _make("yolov5l", nc, **kw)


def yolov5x(nc: int = 80, **kw):
    return _make("yolov5x", nc, **kw)


def yolov5s6(nc: int = 80, **kw):
    return _make("yolov5s6", nc, **kw)


def yolov5m6(nc: int = 80, **kw):
    return _make("yolov5m6", nc, **kw)


def yolov5l6(nc: int = 80, **kw):
    return _make("yolov5l6", nc, **kw)


def yolov5x6(nc: int = 80, **kw):
    return _make("yolov5x6", nc, **kw)


def yolov5s_gpt4(nc: int = 6, **kw):
    """The two-stream yolov5s with GPT fusion at four levels."""
    return _make("yolov5s_gpt4", nc, **kw)


def mmidet(nc: int = 6, scale: str = "l", fusion: str = "fuse3_fourier",
           **kw):
    """The two-stream flagship constructor."""
    return _make(f"yolov5{scale}_{fusion}", nc, **kw)


def custom(deploy_bundle: str, conf: float = 0.25, iou: float = 0.45,
           augment: bool = False, device="cuda", dtype=None):
    """Load from a deploy bundle dir (ref ``hubconf.custom``)."""
    from mmidet_tpu_torch.deploy.export import load_deploy_bundle
    spec, sd, meta = load_deploy_bundle(deploy_bundle)
    return _wrap(spec, sd, meta["names"], meta.get("img_size", 640), conf,
                 iou, augment, device, dtype)
