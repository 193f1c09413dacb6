"""Detection service: image bytes in, detection records out.

Counterpart of ``mmidet_tpu/deploy/serve.py`` (``_preprocess``,
``_records``, ``DetectionService``); reference
``utils/flask_rest_api/restapi.py:16-29``, extended to two streams.  The
micro-batching front end and the HTTP handler are not ported yet.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from mmidet_tpu_torch.data.datasets import letterbox_np
from mmidet_tpu_torch.ops.nms import non_max_suppression


def _preprocess(img_bytes: bytes, s: int):
    """decode -> letterbox; returns (lb_uint8, ratio, (dw, dh))."""
    from PIL import Image
    img0 = np.asarray(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
    lb, r, (dw, dh) = letterbox_np(img0, (s, s))
    return lb, r, (dw, dh)


def _records(dets: np.ndarray, valid: np.ndarray, r: float, dw: float,
             dh: float, names) -> list[dict]:
    out = []
    for x1, y1, x2, y2, conf, cls in dets[valid]:
        out.append({
            "xmin": float((x1 - dw) / r), "ymin": float((y1 - dh) / r),
            "xmax": float((x2 - dw) / r), "ymax": float((y2 - dh) / r),
            "confidence": float(conf),
            "class": int(cls),
            "name": names[int(cls)],
        })
    return out


class DetectionService:
    """Holds the model on ``device`` plus pre/postprocessing.  The default
    device is the card; without CUDA the constructor raises instead of
    running on the CPU (pass ``device="cpu"`` for that)."""

    def __init__(self, model: torch.nn.Module, names, img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetectionService: CUDA is not available "
                               "(pass device='cpu' to run on the CPU)")
        self.model = model.to(self.device).eval()
        self.names = names
        self.img_size = img_size
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        # warm up at construction so the first request does not pay for
        # the kernels' build and the first launches
        z = np.zeros((img_size, img_size, 3), np.uint8)
        self._infer(z, z)

    @torch.inference_mode()
    def _infer(self, lb_rgb: np.ndarray, lb_ir: np.ndarray):
        def batch(lb):
            return (torch.from_numpy(lb).to(self.device)[None].float()
                    / 255.0)
        pred = self.model(batch(lb_rgb), batch(lb_ir))["pred"]
        dets, valid = non_max_suppression(pred.float(),
                                          conf_thres=self.conf_thres,
                                          iou_thres=self.iou_thres)
        return dets[0].cpu().numpy(), valid[0].cpu().numpy()

    def predict(self, rgb_bytes: bytes, ir_bytes: bytes) -> list[dict]:
        s = self.img_size
        lb_r, r, (dw, dh) = _preprocess(rgb_bytes, s)
        lb_i, _, _ = _preprocess(ir_bytes, s)
        dets, valid = self._infer(lb_r, lb_i)
        return _records(dets, valid, r, dw, dh, self.names)
