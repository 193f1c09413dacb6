"""Resume every interrupted training run found under a runs directory:
the spot-VM restart loop (reference ``utils/aws/resume.py:1-37``; the JAX
package's ``tools/resume_all.py``).

A run dir holds the ``opt.yaml`` the trainer wrote and its checkpoints
``ckpt/epoch<N>.pt`` (``train/checkpoint.py``).  A run whose newest
checkpoint is short of ``epochs - 1`` is resumed in place, one after
another, on the card.  A run of the JAX package (orbax step folders
``ckpt/<step>/``) is not a run of this package: it is named and skipped.

    python -m mmidet_tpu_torch.tools.resume_all [runs/train] [--dry-run]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import torch


def find_interrupted(search_dir: str, skipped: list | None = None) -> list:
    """``(workdir, opt, last_epoch)`` of every interrupted run under
    ``search_dir``, in path order; the workdirs of JAX-package runs go to
    ``skipped``."""
    import yaml

    from mmidet_tpu_torch.train.checkpoint import checkpoints
    out = []
    for opt_path in sorted(glob.glob(os.path.join(search_dir, "**",
                                                  "opt.yaml"),
                                     recursive=True)):
        workdir = os.path.dirname(opt_path)
        ckpt = os.path.join(workdir, "ckpt")
        if not os.path.isdir(ckpt):
            continue
        found = checkpoints(ckpt)
        if not found:
            if skipped is not None and any(
                    f.isdigit() and os.path.isdir(os.path.join(ckpt, f))
                    for f in os.listdir(ckpt)):
                skipped.append(workdir)
            continue
        with open(opt_path) as fh:
            opt = yaml.safe_load(fh) or {}
        last_epoch = int(os.path.basename(found[-1])[len("epoch"):-3])
        if last_epoch < int(opt.get("epochs", 0)) - 1:
            out.append((workdir, opt, last_epoch))
    return out


def main(argv=None, device: str | torch.device = "cuda") -> list:
    """Resume every interrupted run (``--dry-run``: list them only);
    returns what each ``train`` returned."""
    p = argparse.ArgumentParser("resume_all")
    p.add_argument("search_dir", nargs="?", default="runs/train")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    from mmidet_tpu_torch.eval.evaluator import eval_device
    from mmidet_tpu_torch.train.trainer import TrainConfig, train
    eval_device(device)
    skipped = []
    todo = find_interrupted(args.search_dir, skipped)
    for workdir in skipped:
        print(f"skipping {workdir}: JAX-package checkpoints (ckpt/<step>/), "
              "not a run of this package")
    print(f"{len(todo)} interrupted run(s) found")
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    results = []
    for workdir, opt, last_epoch in todo:
        print(f"resuming {workdir} from epoch {last_epoch + 1} "
              f"(target {opt['epochs']})")
        if args.dry_run:
            continue
        opt = {k: v for k, v in opt.items() if k in fields}
        if isinstance(opt.get("freeze"), list):
            opt["freeze"] = tuple(opt["freeze"])
        results.append(train(TrainConfig(**{**opt, "resume": workdir}),
                             device=device))
    return results


if __name__ == "__main__":
    main()
