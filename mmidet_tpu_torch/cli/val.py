"""Evaluation CLI: the reference ``test.py`` surface (test.py:311-384):
mAP table, --task speed benchmark, --task study resolution sweep.

Counterpart of ``mmidet_tpu/cli/val.py``.  Runs on the card:

    python -m mmidet_tpu_torch.cli.val --cfg yolov5l_fuse3_fourier \\
        --data data.yaml --weights model.pt

``main(argv, device="cpu")`` runs it on the CPU (a keyword argument, not
a flag).  Weights come from a ``.pt`` by the reference's names (a state
dict, ``{"model": sd}`` / ``{"ema": sd}``, or the reference's own
checkpoint of pickled modules) or a deploy bundle dir
(``deploy/export.py``); without ``--weights`` the model starts from a
seeded fresh init.  ``--int8`` runs the s8-storage deploy form
(``nn/quant.py``), calibrated on the first val batch.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from mmidet_tpu_torch.data.datasets import PairedDataset, load_data_yaml
from mmidet_tpu_torch.data.loader import PairedLoader, RectLoader
from mmidet_tpu_torch.eval.evaluator import eval_device, evaluate
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.spec import load_yolo_yaml
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.nn.quant import make_quant_deploy
from mmidet_tpu_torch.utils.general import increment_path, set_logging


def load_state_dict_file(path: str, reference_repo: str | None = None
                         ) -> dict[str, torch.Tensor]:
    """The weights in ``path`` by the reference's names: a ``.pt`` read by
    ``train.checkpoint.load_torch_checkpoint`` (a state dict, the port's
    checkpoint, or the reference's checkpoint of pickled modules, EMA
    preferred, f32; ``reference_repo``: the reference checkout its pickle
    imports, None here as in the JAX package's ``cli/val.py:35-40``), or a
    deploy bundle dir (``deploy/export.py``), as the JAX package's
    ``train/trainer.py:188-191`` reads one."""
    from mmidet_tpu_torch.deploy.export import is_bundle, load_deploy_bundle
    from mmidet_tpu_torch.train.checkpoint import load_torch_checkpoint
    if os.path.isdir(path):
        if not is_bundle(path):
            raise ValueError(f"{path} is a directory without model.json: "
                             "give a .pt state dict or a deploy bundle "
                             "(orbax checkpoints are the JAX package's "
                             "format)")
        return load_deploy_bundle(path)[1]
    return load_torch_checkpoint(path, reference_repo=reference_repo)


@torch.no_grad()
def load_weights(model: torch.nn.Module, sd: dict) -> list[str]:
    """Copy every entry of ``sd`` whose name and shape match into
    ``model``; the others keep their init (the reference's
    ``intersect_dicts``, train.py:544-547, e.g. a Detect head of another
    nc).  Returns the model's keys that received nothing."""
    own = model.state_dict()
    missing = []
    for k, v in own.items():
        if k in sd and tuple(sd[k].shape) == tuple(v.shape):
            v.copy_(sd[k])
        elif not k.endswith("num_batches_tracked"):
            missing.append(k)
    return missing


def kernel_routes(spec, use_cem: bool) -> dict:
    """The detector's kernel flags for ``spec``'s deploy form on the card:
    K3 for the CEM; K4 (``kernel_merge``) where a fusion level is GPT1 or
    GPT1_fourier, as the flagship runs; else K1 (``kernel_fusion``) for
    GPT levels."""
    names = {ld.name for ld in spec.layers}
    merge = bool(names & {"GPT1", "GPT1_fourier"})
    return {"kernel_cem": use_cem, "kernel_merge": merge,
            "kernel_fusion": "GPT" in names and not merge}


def spec_by_name(model_name: str, nc: int | None = None):
    """A zoo name or a model YAML path -> its ``ModelSpec``."""
    return load_yolo_yaml(model_name, nc=nc) \
        if model_name.endswith((".yaml", ".yml")) \
        else get_model_spec(model_name, nc=nc)


def build_model(spec, sd: dict | None = None, use_cem: bool = True,
                seed: int = 0, **flags) -> TwoStreamDetector:
    """The detector in the form ``sd`` holds (a seeded init when ``sd`` is
    None): unfused, BN-folded (no BN entry), or quantized (``out_scale``
    buffers), with ``sd`` loaded (``load_weights``); on the CPU, in f32.
    ``flags`` are the detector's kernel flags."""
    fused = sd is not None and not any(
        k.endswith("running_mean") for k in sd)
    quant = sd is not None and any(k.endswith(".out_scale") for k in sd)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TwoStreamDetector(spec, use_cem=use_cem, fused=fused,
                                  quant=quant, **flags)
    if sd is not None:
        missing = load_weights(model, sd)
        if missing:
            logging.warning("%d of the model's tensors are not in the "
                            "weights and keep their init, e.g. %s",
                            len(missing), missing[:3])
    return model


def deploy_model(spec, sd: dict | None, use_cem: bool, dev: torch.device,
                 dtype: torch.dtype | None = None,
                 seed: int = 0) -> TwoStreamDetector:
    """``build_model`` in the deploy form on ``dev``: BN folded, eval mode;
    on the card ``dtype`` bf16 by default and the kernel routes of
    ``kernel_routes``, on the CPU the plain routes in f32 by default."""
    flags = kernel_routes(spec, use_cem) if dev.type == "cuda" else {}
    model = build_model(spec, sd, use_cem, seed, **flags)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return fold_batchnorm(model.eval()).to(dev, dtype)


def load_model_and_vars(model_name: str, weights: str, nc: int,
                        dtype: torch.dtype | None = None,
                        use_cem: bool = True, device="cuda", seed: int = 0):
    """Build the model, load ``weights`` (a ``.pt`` state dict or a deploy
    bundle dir; "" for a seeded fresh init), fold BN and return (model,
    spec) on ``device`` (``deploy_model``).  The JAX package returns
    (model, variables, spec); here the weights live in the module."""
    dev = eval_device(device)
    spec = spec_by_name(model_name, nc)
    sd = load_state_dict_file(weights) if weights else None
    return deploy_model(spec, sd, use_cem, dev, dtype, seed), spec


def apply_int8(model, ds, img_size: int, clip: float = 1.0):
    """The s8-storage twin of ``model``, calibrated on the first val batch
    of at most 4 pairs (JAX ``cli/val.py:_apply_int8``)."""
    dev = next(model.parameters()).device
    calib = next(iter(PairedLoader(ds, min(4, len(ds)), img_size,
                                   drop_last=False, scaleup=False)))
    rgb, ir = (torch.from_numpy(calib[k]).to(dev).float() / 255.0
               for k in ("rgb", "ir"))
    return make_quant_deploy(model, [(rgb, ir)], clip=clip)


def build_parser():
    p = argparse.ArgumentParser("mmidet-tpu-torch val")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--cfg", type=str, default="yolov5l_fuse3_fourier")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--task", type=str, default="val",
                   choices=["val", "test", "speed", "study"])
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--merge", action="store_true",
                   help="merge-NMS: weighted-mean box merging (ref "
                        "general.py:566-574)")
    p.add_argument("--save-json", type=str, default="",
                   help="dump COCO-format detections to this path")
    p.add_argument("--coco91", action="store_true",
                   help="map class ids to COCO-paper 91-index ids in the "
                        "JSON (ref coco80_to_coco91_class)")
    p.add_argument("--rect", action="store_true",
                   help="aspect-bucketed rectangular eval (reference "
                        "rect=True pad=0.5)")
    p.add_argument("--augment", action="store_true",
                   help="TTA eval (3 scale/flip passes, ref --augment)")
    p.add_argument("--single-cls", action="store_true",
                   help="treat as single-class dataset")
    p.add_argument("--save-txt", action="store_true",
                   help="save per-image predictions to "
                        "<project>/<name>/labels/*.txt")
    p.add_argument("--save-conf", action="store_true",
                   help="append confidences in --save-txt rows")
    p.add_argument("--save-hybrid", action="store_true",
                   help="append ground-truth labels in --save-txt rows")
    p.add_argument("--project", type=str, default="runs/test")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="s8-storage quantized deploy (activations stored "
                        "as int8; scales calibrated on the first val "
                        "batch, see nn/quant.py)")
    p.add_argument("--int8-clip", type=float, default=1.0,
                   help="calibration absmax clip for --int8")
    return p


def main(argv=None, device="cuda"):
    set_logging()
    args = build_parser().parse_args(argv)
    data = load_data_yaml(args.data)
    nc = 1 if args.single_cls else int(data["nc"])
    names = ["item"] if args.single_cls else data.get("names")
    model, spec = load_model_and_vars(args.cfg, args.weights, nc,
                                      device=device)
    ds = PairedDataset(data["val_rgb"], data["val_ir"],
                       nc=None if args.single_cls else nc)
    if args.single_cls:  # collapse labels (ref --single-cls)
        for lab in ds.labels:
            if len(lab):
                lab[:, 0] = 0.0
    if args.int8:
        model = apply_int8(model, ds, args.img_size, clip=args.int8_clip)

    if args.task in ("val", "test"):
        out_dir = None
        if args.save_txt:
            out_dir = increment_path(os.path.join(args.project, args.name),
                                     args.exist_ok)
        # scaleup=False: reference val-time letterbox only scales DOWN
        # (datasets.py:1484-1487)
        loader = RectLoader(ds, args.batch_size, args.img_size) \
            if args.rect else PairedLoader(ds, args.batch_size,
                                           args.img_size, drop_last=False,
                                           scaleup=False)
        res = evaluate(model, loader, nc,
                       conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                       names=names, verbose=True,
                       save_json=args.save_json or None,
                       augment=args.augment, coco91=args.coco91,
                       save_txt_dir=(os.path.join(out_dir, "labels")
                                     if out_dir else None),
                       save_conf=args.save_conf,
                       save_hybrid=args.save_hybrid, merge=args.merge,
                       device=device)
        print(json.dumps({"P": res.mp, "R": res.mr, "mAP50": res.map50,
                          "mAP75": res.map75, "mAP": res.map,
                          "speed_ms": res.speed_ms[0]}))
        return res
    if args.task == "speed":
        # conf 0.25 / iou 0.45, timing only (ref test.py:367-369)
        loader = PairedLoader(ds, args.batch_size, args.img_size,
                              drop_last=False)
        res = evaluate(model, loader, nc, conf_thres=0.25,
                       iou_thres=0.45, names=names, device=device)
        print(f"speed: {res.speed_ms[0]:.1f} ms/img inference")
        return res
    # study: resolution sweep 256..1536 step 128 (ref test.py:371-384)
    rows = []
    for sz in range(256, 1537, 128):
        loader = PairedLoader(ds, args.batch_size, sz, drop_last=False)
        res = evaluate(model, loader, nc, names=names, device=device)
        rows.append((sz, res.map50, res.map, res.speed_ms[0]))
        print(f"{sz}: mAP50 {res.map50:.4f} mAP {res.map:.4f} "
              f"{res.speed_ms[0]:.1f} ms/img")
    return rows


if __name__ == "__main__":
    main()
