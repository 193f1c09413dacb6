"""Two-stream detection CLI: the reference ``detect_twostream.py`` surface
(detect_twostream.py:19-196): paired image/dir inference, NMS, annotated
``_rgb``/``_ir`` outputs, label txt files, crops, FPS report.

Counterpart of ``mmidet_tpu/cli/detect.py``.  Runs on the card:

    python -m mmidet_tpu_torch.cli.detect --cfg yolov5l_fuse3_fourier \\
        --source1 rgb_dir --source2 ir_dir --weights model.pt

``main(argv, device="cpu")`` runs it on the CPU.  ``--int8`` runs the
s8-storage deploy form (``nn/quant.py``), calibrated on the first source
pair.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mmidet_tpu_torch.cli.val import load_model_and_vars
from mmidet_tpu_torch.data.datasets import discover_images, letterbox_np
from mmidet_tpu_torch.eval.evaluator import eval_device
from mmidet_tpu_torch.models.tta import forward_tta
from mmidet_tpu_torch.nn.quant import make_quant_deploy
from mmidet_tpu_torch.ops.nms import non_max_suppression
from mmidet_tpu_torch.utils.general import (increment_path, save_one_box,
                                            set_logging)
from mmidet_tpu_torch.utils.plots import colors, plot_one_box


def build_parser():
    p = argparse.ArgumentParser("mmidet-tpu-torch detect")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--cfg", type=str, default="yolov5l_fuse3_fourier")
    p.add_argument("--source1", type=str, required=True, help="RGB images")
    p.add_argument("--source2", type=str, required=True, help="IR images")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--names", type=str, nargs="*", default=None)
    p.add_argument("--project", type=str, default="runs/detect")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true",
                   help="append confidence to --save-txt rows (ref flag)")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="TTA inference (3 scale/flip passes)")
    p.add_argument("--merge", action="store_true",
                   help="merge-NMS: weighted-mean box merging (ref "
                        "general.py:566-574)")
    p.add_argument("--agnostic-nms", action="store_true",
                   help="class-agnostic NMS")
    p.add_argument("--classes", type=int, nargs="+", default=None,
                   help="filter detections to these class ids")
    p.add_argument("--save-crop", action="store_true",
                   help="save cropped detection boxes under crops/<class>/ "
                        "(ref --save-crop)")
    p.add_argument("--line-thickness", type=int, default=2,
                   help="box outline thickness in px (ref --line-thickness)")
    p.add_argument("--hide-labels", action="store_true",
                   help="draw boxes without class labels (ref --hide-labels)")
    p.add_argument("--hide-conf", action="store_true",
                   help="omit confidences from labels (ref --hide-conf)")
    p.add_argument("--exist-ok", action="store_true",
                   help="reuse --project/--name without incrementing")
    p.add_argument("--int8", action="store_true",
                   help="s8-storage quantized deploy (scales calibrated "
                        "on the first source pair, see nn/quant.py)")
    p.add_argument("--int8-clip", type=float, default=1.0,
                   help="calibration absmax clip for --int8")
    return p


def main(argv=None, device="cuda"):
    set_logging()
    args = build_parser().parse_args(argv)
    from PIL import Image
    dev = eval_device(device)
    model, spec = load_model_and_vars(args.cfg, args.weights, args.nc,
                                      device=dev)
    names = args.names or [str(i) for i in range(args.nc)]
    out_dir = increment_path(os.path.join(args.project, args.name),
                             args.exist_ok)
    os.makedirs(out_dir, exist_ok=True)

    rgb_files = discover_images(args.source1)
    ir_files = discover_images(args.source2)
    assert len(rgb_files) == len(ir_files), "paired sources length mismatch"

    s = args.img_size
    if args.int8:
        calib = [torch.from_numpy(letterbox_np(np.asarray(
            Image.open(f).convert("RGB")), (s, s))[0]).to(dev)[None].float()
            / 255.0 for f in (rgb_files[0], ir_files[0])]
        model = make_quant_deploy(model, [tuple(calib)],
                                  clip=args.int8_clip)

    @torch.inference_mode()
    def infer(lb_rgb, lb_ir):
        def batch(lb):
            return torch.from_numpy(lb).to(dev)[None].float() / 255.0

        def fwd(r, i):
            return model(r, i)["pred"]
        rgb, ir = batch(lb_rgb), batch(lb_ir)
        if args.augment:  # TTA (ref detect_twostream.py --augment)
            pred = forward_tta(fwd, rgb, ir, gs=int(max(spec.strides)))
        else:
            pred = fwd(rgb, ir)
        dets, valid = non_max_suppression(
            pred.float(), conf_thres=args.conf_thres,
            iou_thres=args.iou_thres, agnostic=args.agnostic_nms,
            classes=tuple(args.classes) if args.classes else None,
            merge=args.merge)
        return dets[0].cpu().numpy(), valid[0].cpu().numpy()

    times = []
    for rf, irf in zip(rgb_files, ir_files):
        im0_rgb = np.asarray(Image.open(rf).convert("RGB"))
        im0_ir = np.asarray(Image.open(irf).convert("RGB"))
        lb_rgb, r, (dw, dh) = letterbox_np(im0_rgb, (s, s))
        lb_ir, _, _ = letterbox_np(im0_ir, (s, s))
        t0 = time.perf_counter()
        d, v = infer(lb_rgb, lb_ir)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        d = d[v]
        # letterboxed -> original coords
        if len(d):
            d[:, [0, 2]] = np.clip((d[:, [0, 2]] - dw) / r, 0,
                                   im0_rgb.shape[1])
            d[:, [1, 3]] = np.clip((d[:, [1, 3]] - dh) / r, 0,
                                   im0_rgb.shape[0])
        base = os.path.splitext(os.path.basename(rf))[0]
        if args.save_txt:
            # YOLO label format, as the reference writes it
            # (detect_twostream.py:133-140): cls cx cy w h normalized,
            # confidence only with --save-conf
            h0, w0 = im0_rgb.shape[:2]
            with open(os.path.join(out_dir, base + ".txt"), "w") as fh:
                for x1, y1, x2, y2, conf, cls in d:
                    row = (int(cls), (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                           (x2 - x1) / w0, (y2 - y1) / h0)
                    line = f"{row[0]} " + " ".join(f"{x:.6f}"
                                                   for x in row[1:])
                    if args.save_conf:
                        line += f" {conf:.6f}"
                    fh.write(line + "\n")
        if args.save_crop:
            # crops/<class>/<stem>_<k>.jpg from the RGB frame (ref
            # save_one_box, detect_twostream.py:151 / general.py:684-706)
            for k, (*box, conf, cls) in enumerate(d):
                crop_dir = os.path.join(out_dir, "crops", names[int(cls)])
                os.makedirs(crop_dir, exist_ok=True)
                save_one_box(box, im0_rgb,
                             os.path.join(crop_dir, f"{base}_{k}.jpg"))
        if not args.nosave:
            ann_rgb, ann_ir = im0_rgb.copy(), im0_ir.copy()
            for *box, conf, cls in d:
                label = None if args.hide_labels else (
                    names[int(cls)] if args.hide_conf
                    else f"{names[int(cls)]} {conf:.2f}")
                ann_rgb = plot_one_box(box, ann_rgb, colors(int(cls)),
                                       label, args.line_thickness)
                ann_ir = plot_one_box(box, ann_ir, colors(int(cls)), label,
                                      args.line_thickness)
            Image.fromarray(ann_rgb).save(
                os.path.join(out_dir, base + "_rgb.jpg"))
            Image.fromarray(ann_ir).save(
                os.path.join(out_dir, base + "_ir.jpg"))
        print(f"{base}: {len(d)} dets, {times[-1] * 1e3:.1f} ms "
              f"({1.0 / times[-1]:.1f} Hz)")

    if times[1:]:
        avg = len(times[1:]) / sum(times[1:])
        print(f"Average Speed: {avg:.1f} Hz (excl. first)")
    print(f"results saved to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
