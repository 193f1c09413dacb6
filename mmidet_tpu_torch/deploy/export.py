"""Deploy bundles: a model's weights and metadata in one directory.

Counterpart of ``mmidet_tpu/deploy/export.py`` (``export_deploy_bundle``,
``load_deploy_bundle``, ``main``); reference ``models/export.py:24-127``.
A bundle is ``model.json`` (the JAX package's keys and layout: nc, names,
anchors, strides, multiples, img_size, layers) and ``model.pt``, the
module's state dict by the reference's names (``torch.save``), where the
JAX package writes orbax variables.  The state dict is the module's as it
stands: unfused (BN kept, trainable), folded, or quantized (with the
``out_scale`` buffers); ``cli.val.build_model`` rebuilds each form.

The portable-graph legs (StableHLO's counterpart ``torch.export``,
SavedModel / TFLite, ONNX) are not ported: the kernels are loaded through
``ctypes`` (``mmidet_tpu_torch/kernels.py``), so ``torch.export`` cannot
trace them until they are ``torch.library`` custom ops with fake
implementations (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

STATE_FILE = "model.pt"


def export_deploy_bundle(path: str, model: torch.nn.Module, spec,
                         names: list[str] | None = None,
                         img_size: int = 640) -> str:
    """Write ``model.json`` and ``model.pt`` (``model``'s state dict, on
    the CPU) under ``path``; returns ``path``."""
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(path, STATE_FILE))
    meta = {
        "nc": spec.nc,
        "names": names or [str(i) for i in range(spec.nc)],
        "anchors": [list(a) for a in spec.anchors],
        "strides": list(spec.strides),
        "depth_multiple": spec.depth_multiple,
        "width_multiple": spec.width_multiple,
        "img_size": img_size,
        "layers": [dataclasses.asdict(ld) for ld in spec.layers],
    }
    with open(os.path.join(path, "model.json"), "w") as fh:
        json.dump(meta, fh, indent=1, default=list)
    return path


def is_bundle(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "model.json"))


def load_deploy_bundle(path: str):
    """(spec, state dict, meta) from a bundle dir; the ``ModelSpec`` is
    rebuilt from ``model.json`` exactly as the JAX package rebuilds it
    (fields the file does not hold keep their defaults)."""
    from mmidet_tpu_torch.models.spec import LayerDef, ModelSpec
    with open(os.path.join(path, "model.json")) as fh:
        meta = json.load(fh)
    spec = ModelSpec(
        nc=meta["nc"],
        anchors=tuple(tuple(a) for a in meta["anchors"]),
        layers=tuple(LayerDef(
            f=tuple(ld["f"]) if isinstance(ld["f"], list) else ld["f"],
            n=ld["n"], name=ld["name"],
            args=tuple(tuple(a) if isinstance(a, list) else a
                       for a in ld["args"]))
            for ld in meta["layers"]),
        depth_multiple=meta["depth_multiple"],
        width_multiple=meta["width_multiple"],
        strides=tuple(meta["strides"]))
    sd = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                    weights_only=True)
    return spec, sd, meta


def main(argv=None):
    """Export CLI (the reference's ``models/export.py``): weights in, a
    deploy bundle out.  The bundle holds the unfused model, as the JAX
    package's does, so that it also serves as a training init."""
    import argparse

    from mmidet_tpu_torch.cli.val import (build_model, load_state_dict_file,
                                          spec_by_name)
    from mmidet_tpu_torch.utils.general import set_logging

    p = argparse.ArgumentParser("mmidet-tpu-torch export")
    p.add_argument("--cfg", type=str, default="yolov5l_fuse3_fourier",
                   help="zoo model name or model YAML path")
    p.add_argument("--weights", type=str, default="",
                   help=".pt state dict or deploy bundle (blank: seeded "
                        "init)")
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--names", type=str, nargs="*", default=None)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--out", type=str, default="runs/export/bundle")
    p.add_argument("--savedmodel", action="store_true",
                   help="TF SavedModel (not ported: raises)")
    p.add_argument("--tflite", action="store_true",
                   help="TFLite (not ported: raises)")
    p.add_argument("--onnx", action="store_true",
                   help="ONNX graph (not ported: raises)")
    args = p.parse_args(argv)
    set_logging()
    for flag, what in ((args.savedmodel, "--savedmodel"),
                       (args.tflite, "--tflite"), (args.onnx, "--onnx")):
        if flag:
            raise NotImplementedError(
                f"{what}: the portable-graph export is not ported; it needs "
                "the kernels as torch.library custom ops (ROADMAP A15)")
    spec = spec_by_name(args.cfg, args.nc)
    model = build_model(spec, load_state_dict_file(args.weights)
                        if args.weights else None)
    path = export_deploy_bundle(args.out, model, spec, names=args.names,
                                img_size=args.img_size)
    print(f"exported deploy bundle -> {path}")
    return path


if __name__ == "__main__":
    main()
