"""mAP evaluation: batched inference + NMS on the card, host-side IoU
matching and AP aggregation.

Counterpart of ``mmidet_tpu/eval/evaluator.py``; reference ``test.test``
(``test.py:21-308``): conf 0.001 / iou 0.6 multi-label NMS, 10 IoU
thresholds 0.5:0.95, P/R at max F1, mAP@.5 / mAP@.75 / mAP@.5:.95,
per-class table, speed report.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from mmidet_tpu_torch.eval.metrics import (ConfusionMatrix, ap_per_class,
                                           coco80_to_coco91_class,
                                           match_predictions)
from mmidet_tpu_torch.models.tta import forward_tta
from mmidet_tpu_torch.ops.boxes import scale_coords
from mmidet_tpu_torch.ops.nms import non_max_suppression
from mmidet_tpu_torch.parallel.mesh import default_devices, shard_inference


@dataclasses.dataclass
class EvalResults:
    mp: float
    mr: float
    map50: float
    map75: float
    map: float
    per_class: dict
    speed_ms: tuple[float, float]   # inference, nms per image
    nc: int

    def fitness_vector(self) -> np.ndarray:
        return np.asarray([[self.mp, self.mr, self.map50, self.map]])


def _scale_boxes(boxes: np.ndarray, ratio_pad, orig_shape) -> np.ndarray:
    """Letterboxed xyxy -> original-image coordinates
    (``ops.boxes.scale_coords``); ``ratio_pad`` is the loaders'
    (gain, (padw, padh))."""
    r, pad = ratio_pad
    return scale_coords(None, torch.from_numpy(boxes), orig_shape,
                        ((r, r), pad)).numpy()


def eval_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card unless the caller asks
    for the CPU, and an error, not the CPU, when the card is missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass device='cpu' to run "
                           "on the CPU)")
    return device


def infer_batch(model, rgb: torch.Tensor, ir: torch.Tensor | None,
                conf_thres: float, iou_thres: float, max_det: int = 300,
                augment: bool = False, merge: bool = False):
    """Forward (optionally TTA) + the evaluator's NMS on one batch of NHWC
    [0, 1] images.  ``pre_nms_topk`` is the reference eval protocol's
    max_nms (general.py:555-557): at conf 0.001 + multi_label the pool
    easily exceeds 4096, and a smaller pool truncates the recall tail."""
    def fwd(r, i=None):
        return model(r, i)["pred"]
    if augment:  # TTA (ref test.py --augment)
        pred = forward_tta(fwd, rgb, ir, gs=int(max(model.spec.strides)))
    else:
        pred = fwd(rgb, ir)
    return non_max_suppression(pred.float(), conf_thres=conf_thres,
                               iou_thres=iou_thres, max_det=max_det,
                               pre_nms_topk=30000, multi_label=True,
                               merge=merge)


@torch.inference_mode()
def evaluate(model, loader, nc: int,
             conf_thres: float = 0.001, iou_thres: float = 0.6,
             max_det: int = 300, names=None, two_stream: bool = True,
             verbose: bool = False, save_json: str | None = None,
             confusion_dir: str | None = None,
             augment: bool = False, coco91: bool = False,
             media_dir: str | None = None,
             media_max: int = 16,
             save_txt_dir: str | None = None,
             save_conf: bool = False,
             save_hybrid: bool = False,
             merge: bool = False,
             device: str | torch.device = "cuda",
             shard: bool = True, devices=None) -> EvalResults:
    """The JAX package's ``evaluate`` without ``variables``: the weights
    live in ``model``, an ``nn.Module`` that is moved to ``device`` (the
    card by default; without CUDA this raises unless ``device="cpu"``)
    and put in eval mode.  With ``shard`` and more than one entry in
    ``devices`` (default: every visible card for a bare ``"cuda"``) the
    batch is split over a replica of the model on each entry
    (``parallel.mesh.shard_inference``; a ragged batch padded to a
    multiple of their count, JAX :134-170) and the predictions gathered on
    the first: the forward has no cross-example math, so the records are
    one device's.

    ``save_json``: COCO-format detection dump (ref test.py --save-json).
    ``confusion_dir``: an IoU-matched confusion matrix (ref test.py
    ConfusionMatrix + plot).  ``augment``: TTA, three scale/flip passes
    concatenated before NMS (ref test.py --augment).  ``coco91``: 80-index
    class ids mapped to the COCO-paper 91-index ids in the JSON.
    ``media_dir``: up to ``media_max`` val images annotated with predicted
    boxes.  ``save_txt_dir``: one ``<stem>.txt`` per image with predictions
    as ``cls xywh`` normalized to the ORIGINAL frame (+``conf`` when
    ``save_conf``); ``save_hybrid`` appends the ground-truth labels too
    (ref test.py:146-171).  ``speed_ms[0]``: inference + NMS per image,
    host-to-card copy to detections on the host, after
    ``torch.cuda.synchronize()``."""
    dev = eval_device(device)
    devs = default_devices(dev) if devices is None else \
        [eval_device(d) for d in devices]
    if shard and len(devs) > 1:
        model, dev = shard_inference(model.eval(), devs), devs[0]
    else:
        model = model.to(dev).eval()
    iouv = np.linspace(0.5, 0.95, 10)
    json_records = []
    cls_map = coco80_to_coco91_class() if coco91 else None
    cm = ConfusionMatrix(nc) if confusion_dir is not None else None

    stats = []
    t_inf = 0.0
    n_img = 0
    n_media = 0
    for batch in loader:
        b0 = batch["rgb"].shape[0]
        t0 = time.perf_counter()
        rgb = torch.from_numpy(batch["rgb"]).to(dev).float() / 255.0
        ir = torch.from_numpy(batch["ir"]).to(dev).float() / 255.0
        dets, valid = infer_batch(model, rgb, ir if two_stream else None,
                                  conf_thres, iou_thres, max_det, augment,
                                  merge)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_inf += time.perf_counter() - t0
        n_img += b0

        ih, iw = rgb.shape[1], rgb.shape[2]
        for si in range(b0):
            d = dets[si][valid[si]]
            lab = batch["targets"][si][batch["mask"][si]]
            orig_shape, ratio_pad = batch["shapes"][si]
            # labels: normalized xywh in padded frame -> xyxy original px
            if len(lab):
                l_xyxy = np.empty((len(lab), 5), np.float32)
                l_xyxy[:, 0] = lab[:, 0]
                cx, cy = lab[:, 1] * iw, lab[:, 2] * ih
                w, h = lab[:, 3] * iw, lab[:, 4] * ih
                l_xyxy[:, 1], l_xyxy[:, 2] = cx - w / 2, cy - h / 2
                l_xyxy[:, 3], l_xyxy[:, 4] = cx + w / 2, cy + h / 2
                l_xyxy[:, 1:] = _scale_boxes(l_xyxy[:, 1:], ratio_pad,
                                             orig_shape)
            else:
                l_xyxy = np.zeros((0, 5), np.float32)
            if media_dir is not None and n_media < media_max:
                from PIL import Image

                from mmidet_tpu_torch.utils.plots import plot_one_box
                os.makedirs(media_dir, exist_ok=True)
                img8 = np.ascontiguousarray(batch["rgb"][si])
                for x1, y1, x2, y2, conf, cls in d:  # letterboxed-frame px
                    nm = (names[int(cls)] if names is not None
                          and int(cls) < len(names) else str(int(cls)))
                    img8 = plot_one_box((x1, y1, x2, y2), img8,
                                        label=f"{nm} {conf:.2f}")
                Image.fromarray(img8).save(
                    os.path.join(media_dir, f"val_{n_media:03d}.jpg"))
                n_media += 1
            if len(d):
                d = d.copy()
                d[:, :4] = _scale_boxes(d[:, :4], ratio_pad, orig_shape)
            files = batch.get("files")
            if save_txt_dir is not None:
                os.makedirs(save_txt_dir, exist_ok=True)
                stem = os.path.splitext(os.path.basename(
                    files[si]))[0] if files else f"img{n_img - b0 + si}"
                oh, ow = orig_shape
                lines = []
                for x1, y1, x2, y2, conf, cls in d:
                    xywh = ((x1 + x2) / 2 / ow, (y1 + y2) / 2 / oh,
                            (x2 - x1) / ow, (y2 - y1) / oh)
                    row = (int(cls), *xywh) + ((float(conf),) if save_conf
                                               else ())
                    lines.append(" ".join(f"{v:.6g}" for v in row))
                if save_hybrid:  # append GT for auto-labelling (ref)
                    for c_, x1, y1, x2, y2 in l_xyxy:
                        xywh = ((x1 + x2) / 2 / ow, (y1 + y2) / 2 / oh,
                                (x2 - x1) / ow, (y2 - y1) / oh)
                        lines.append(" ".join(
                            f"{v:.6g}" for v in (int(c_), *xywh)))
                with open(os.path.join(save_txt_dir, stem + ".txt"),
                          "w") as fh:
                    fh.write("\n".join(lines) + ("\n" if lines else ""))
            if cm is not None:
                cm.process_batch(d, l_xyxy)
            correct = match_predictions(d, l_xyxy, iouv)
            stats.append((correct, d[:, 4] if len(d) else np.zeros(0),
                          d[:, 5] if len(d) else np.zeros(0),
                          l_xyxy[:, 0]))
            if save_json is not None:
                stem = os.path.splitext(os.path.basename(
                    files[si]))[0] if files else str(si)
                # numeric stems become ints (ref test.py:189): COCO ground
                # truth uses int ids, string '000139' matches nothing
                image_id = int(stem) if stem.isnumeric() else stem
                for x1, y1, x2, y2, conf, cls in d:
                    json_records.append({
                        "image_id": image_id,
                        "category_id": cls_map[int(cls)] if cls_map
                        else int(cls),
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1), float(y2 - y1)],
                        "score": float(conf)})

    if save_json is not None:
        with open(save_json, "w") as fh:
            json.dump(json_records, fh)
    if cm is not None:
        os.makedirs(confusion_dir, exist_ok=True)
        np.savetxt(os.path.join(confusion_dir, "confusion_matrix.txt"),
                   cm.matrix, fmt="%d")
        try:  # the plot is optional (matplotlib); the .txt is always written
            from mmidet_tpu_torch.utils.plots import plot_confusion_matrix
            plot_confusion_matrix(cm.matrix, names or
                                  [str(i) for i in range(nc)],
                                  os.path.join(confusion_dir,
                                               "confusion_matrix.png"))
        except Exception:
            pass
    stats = [np.concatenate(x, 0) for x in zip(*stats)]
    per_class = {}
    if len(stats) and stats[0].any():
        p, r, ap, f1, cls_ids = ap_per_class(*stats)
        ap50, ap75, ap_mean = ap[:, 0], ap[:, 5], ap.mean(1)
        mp, mr = p.mean(), r.mean()
        map50, map75, map_ = ap50.mean(), ap75.mean(), ap_mean.mean()
        for i, c in enumerate(cls_ids):
            name = names[c] if names else str(c)
            per_class[name] = {"p": float(p[i]), "r": float(r[i]),
                               "ap50": float(ap50[i]),
                               "ap": float(ap_mean[i])}
    else:
        mp = mr = map50 = map75 = map_ = 0.0

    speed = (t_inf / max(n_img, 1) * 1e3, 0.0)
    if verbose:
        print(f"{'all':>10s} {n_img:10d} "
              f"P {mp:.3f} R {mr:.3f} mAP@.5 {map50:.3f} "
              f"mAP@.5:.95 {map_:.3f} ({speed[0]:.1f} ms/img)")
        for name, v in per_class.items():
            print(f"{name:>10s} P {v['p']:.3f} R {v['r']:.3f} "
                  f"AP50 {v['ap50']:.3f} AP {v['ap']:.3f}")
    return EvalResults(float(mp), float(mr), float(map50), float(map75),
                       float(map_), per_class, speed, nc)
