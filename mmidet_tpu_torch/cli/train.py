"""Training CLI: the JAX package's ``cli/train.py`` surface (reference
``train.py:948-983``), its 47 options and defaults, on the port's trainer.

    python -m mmidet_tpu_torch.cli.train --data data.yaml

runs on the card, with mosaic batches unless ``--no-mosaic`` (or
``--rect``); ``main(argv, device="cpu")`` runs it on the CPU (a keyword
argument, not a flag).  ``--evolve N`` runs N generations of
``train/evolve.py``, each a run under ``<project>/<name>_gen``, the
history in ``<project>/<name>_evolve/evolve.txt``.  ``--mesh`` (auto/on:
data parallel over every visible card; off: one), ``--n-model`` and
``--tp-min-out`` shape the trainer's mesh (``setup_mesh``).
``--sync-bn`` is accepted and does nothing: a mesh computes BatchNorm's
statistics over the global batch anyway, as the JAX package does.
"""

from __future__ import annotations

import argparse

from mmidet_tpu_torch.train.trainer import TrainConfig, train
from mmidet_tpu_torch.utils.general import set_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mmidet-tpu-torch train")
    p.add_argument("--cfg", type=str, default="yolov5l_fuse3_fourier",
                   help="zoo model name or model YAML path")
    p.add_argument("--data", type=str, required=True,
                   help="dataset YAML (train_rgb/train_ir/val_rgb/val_ir)")
    p.add_argument("--hyp", type=str, default="",
                   help="hyperparameter YAML")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--project", type=str, default="runs/train")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--mesh", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="'auto'/'on': data parallel over every visible "
                        "card (one rank a card); 'off': one device")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor parallelism: the mesh's model axis")
    p.add_argument("--tp-min-out", type=int, default=256,
                   help="shard layers with at least this many out channels")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--resume", type=str, default="",
                   help="run dir (continues in place), checkpoint dir, or "
                        "'latest'")
    p.add_argument("--upload-dataset", action="store_true",
                   help="version the dataset as an artifact")
    p.add_argument("--log-artifacts", action="store_true",
                   help="version checkpoints as model artifacts")
    p.add_argument("--artifact-alias", type=str, default="latest",
                   help="dataset artifact alias to pull")
    p.add_argument("--no-mosaic", action="store_true",
                   help="letterboxed batches with the basic augmentation "
                        "instead of mosaic")
    p.add_argument("--no-cem", action="store_true")
    p.add_argument("--aux-mode", type=str, default="reference",
                   choices=["reference", "full", "off"])
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--optimizer-groups", type=str, default="fixed",
                   choices=["fixed", "reference"])
    p.add_argument("--evolve", type=int, default=0, metavar="GENERATIONS",
                   help="hyperparameter evolution generations")
    p.add_argument("--weights", type=str, default="",
                   help="pretrained weights: a .pt state dict (tolerant "
                        "transfer)")
    p.add_argument("--image-weights", action="store_true",
                   help="resample train images by (1-mAP)^2 class weights")
    p.add_argument("--single-cls", action="store_true",
                   help="train as single-class dataset")
    p.add_argument("--multi-scale", action="store_true",
                   help="resize each batch to a random multiple of the "
                        "largest stride in [0.5, 1.5]x --img-size")
    p.add_argument("--multi-scale-buckets", type=int, default=0,
                   help="cap the multi-scale sizes to N evenly spaced ones "
                        "(0: the whole range)")
    p.add_argument("--rect", action="store_true",
                   help="rectangular (aspect-bucketed) training; disables "
                        "mosaic")
    p.add_argument("--notest", action="store_true",
                   help="only evaluate the final epoch")
    p.add_argument("--nosave", action="store_true",
                   help="only checkpoint the final epoch")
    p.add_argument("--save-period", type=int, default=-1,
                   help="extra checkpoint every N epochs")
    p.add_argument("--exist-ok", action="store_true",
                   help="reuse --project/--name without incrementing")
    p.add_argument("--workers", type=int, default=2,
                   help="loader prefetch depth")
    p.add_argument("--freeze", nargs="+", default=[],
                   help="parameter-name substrings to freeze, e.g. model.0.")
    p.add_argument("--noautoanchor", action="store_true",
                   help="disable the pre-training anchor-fit check")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size: gradient accumulation = "
                        "round(nbs/batch); set = --batch-size to disable")
    p.add_argument("--warmup-floor", type=int, default=1000,
                   help="warmup iteration floor (the reference hardcodes "
                        "1000); lower for short runs")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="BCE label smoothing epsilon (overrides hyp)")
    p.add_argument("--cache-images", action="store_true",
                   help="RAM-cache decoded images after first access")
    p.add_argument("--quad", action="store_true",
                   help="quad batches: groups of 4 -> one 2x-size sample "
                        "(--batch-size divisible by 4)")
    p.add_argument("--bucket", type=str, default="",
                   help="gsutil bucket for per-epoch results upload")
    p.add_argument("--entity", type=str, default="",
                   help="W&B entity")
    p.add_argument("--bbox-interval", type=int, default=-1,
                   help="every N epochs, save annotated val images "
                        "(+W&B bbox media when wandb is live)")
    p.add_argument("--sync-bn", action="store_true",
                   help="accepted; a mesh's BatchNorm statistics are the "
                        "global batch's anyway")
    return p


def main(argv=None, device="cuda"):
    set_logging()
    args = build_parser().parse_args(argv)
    cfg = TrainConfig(
        model=args.cfg, data=args.data, hyp=args.hyp, epochs=args.epochs,
        batch_size=args.batch_size, img_size=args.img_size,
        workdir=f"{args.project}/{args.name}", adam=args.adam,
        mesh=args.mesh, n_model=args.n_model, tp_min_out=args.tp_min_out,
        linear_lr=args.linear_lr, resume=args.resume,
        mosaic_prob=0.0 if args.no_mosaic else 1.0,
        use_cem=not args.no_cem, aux_mode=args.aux_mode, dtype=args.dtype,
        seed=args.seed, eval_every=args.eval_every,
        optimizer_groups=args.optimizer_groups,
        weights=args.weights, image_weights=args.image_weights,
        single_cls=args.single_cls, multi_scale=args.multi_scale,
        multi_scale_buckets=args.multi_scale_buckets, rect=args.rect,
        notest=args.notest, nosave=args.nosave,
        save_period=args.save_period, exist_ok=args.exist_ok,
        workers=args.workers, freeze=tuple(args.freeze),
        upload_dataset=args.upload_dataset,
        log_artifacts=args.log_artifacts,
        artifact_alias=args.artifact_alias,
        autoanchor=not args.noautoanchor,
        warmup_floor=args.warmup_floor, nbs=args.nbs,
        label_smoothing=args.label_smoothing,
        cache_images=args.cache_images, quad=args.quad,
        bucket=args.bucket, entity=args.entity,
        bbox_interval=args.bbox_interval)
    if args.evolve:
        import dataclasses

        from mmidet_tpu_torch.train.evolve import evolve
        from mmidet_tpu_torch.train.trainer import load_hyp

        def train_fn(hyp):
            c = dataclasses.replace(cfg, hyp=hyp,
                                    workdir=cfg.workdir + "_gen")
            return train(c, device=device)["best_fitness"]

        best_fit, best_hyp = evolve(train_fn, load_hyp(cfg.hyp),
                                    generations=args.evolve,
                                    workdir=cfg.workdir + "_evolve")
        print(f"evolve done: best fitness {best_fit:.4f}")
        return {"best_fitness": best_fit, "hyp": best_hyp}

    out = train(cfg, device=device)
    print(f"done: best fitness {out['best_fitness']:.4f} "
          f"-> {out['workdir']}")
    return out


if __name__ == "__main__":
    main()
