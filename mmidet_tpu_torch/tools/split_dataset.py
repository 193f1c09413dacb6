"""Paired-dataset train/val splitter: the 80/20 split of an M3FD-style
layout, keeping RGB, IR and labels aligned by file name (reference
``split_M3FD-8-2.py:6-50``).

A copy of the JAX package's ``tools/split_dataset.py``: the same seed
shuffles the names with the same ``random.Random`` and writes the same
tree, file for file.

    python -m mmidet_tpu_torch.tools.split_dataset <root> [--ratio 0.8]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil


def create_split(root: str, rgb_dir: str = "Vis", ir_dir: str = "Ir",
                 label_dir: str = "labels", ratio: float = 0.8,
                 seed: int = 0, suffix: str = "8_2") -> dict:
    """Copy ``root/{rgb_dir,ir_dir,label_dir}`` into ``root/train_<suffix>``
    and ``root/val_<suffix>``; returns the names of each split."""
    rgb_src = os.path.join(root, rgb_dir)
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(rgb_src)
                   if not f.startswith("."))
    rng = random.Random(seed)
    rng.shuffle(names)
    cut = int(len(names) * ratio)
    splits = {"train_" + suffix: names[:cut], "val_" + suffix: names[cut:]}
    for split, members in splits.items():
        for sub in (rgb_dir, ir_dir, label_dir):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for name in members:
            for sub in (rgb_dir, ir_dir):
                src_dir = os.path.join(root, sub)
                for f in os.listdir(src_dir):
                    if os.path.splitext(f)[0] == name:
                        shutil.copy2(os.path.join(src_dir, f),
                                     os.path.join(root, split, sub, f))
            lbl = os.path.join(root, label_dir, name + ".txt")
            if os.path.isfile(lbl):
                shutil.copy2(lbl, os.path.join(root, split, label_dir,
                                               name + ".txt"))
    print({k: len(v) for k, v in splits.items()})
    return splits


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("split_dataset")
    p.add_argument("root")
    p.add_argument("--rgb-dir", default="Vis")
    p.add_argument("--ir-dir", default="Ir")
    p.add_argument("--label-dir", default="labels")
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    return create_split(a.root, a.rgb_dir, a.ir_dir, a.label_dir, a.ratio,
                        a.seed)


if __name__ == "__main__":
    main()
