"""Deploy export: bundles, the portable graph (``torch.export``) and ONNX.

Counterpart of ``mmidet_tpu/deploy/export.py`` (``export_stablehlo``,
``load_stablehlo``, ``export_deploy_bundle``, ``load_deploy_bundle``,
``main``); reference ``models/export.py:24-127``.

* A bundle is ``model.json`` (the JAX package's keys and layout: nc,
  names, anchors, strides, multiples, img_size, layers), ``model.pt``, the
  module's state dict by the reference's names (``torch.save``), where the
  JAX package writes orbax variables, and ``model.pt2``, the module's
  inference forward as ``torch.export`` saves it, where the JAX package
  writes ``model.stablehlo`` (or ``pt2_export_error.txt`` when the trace
  fails).  The state dict is the module's as it stands: unfused (BN kept,
  trainable), folded, or quantized (with the ``out_scale`` buffers);
  ``cli.val.build_model`` rebuilds each form.
* ``export_program`` / ``load_program``: the counterpart of StableHLO.  The
  kernels K1, K3 and K4 are ``torch.library`` custom ops
  (``torch.ops.mmidet.*``) with fake implementations, so the graph of a
  deploy model on the card holds them as nodes and the loaded program
  launches them; the graph ends at ``pred``, so K2 (NMS) is not in it.
* ``--onnx``: the BN-folded model emitted as an ONNX graph, opset 17
  (``deploy/onnx_export.py``, no onnx package needed).
* ``export_savedmodel`` / ``export_tflite`` (``--savedmodel``,
  ``--tflite``): the counterparts of the JAX package's ``jax2tf`` legs,
  written by the port's own codecs with no TensorFlow: the BN-folded
  model's NHWC graph (``deploy/tf_graph.py``) as a SavedModel of plain TF
  ops (``deploy/tf_proto.py``), converted to a flatbuffer of TFLite
  builtins (``deploy/tflite_fb.py``); ``deploy/tf_np.py`` runs both in
  numpy.  The files are the JAX package's ``native=False`` form: the
  StableHLO-embedding form (``native=True``) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import traceback

import torch

STATE_FILE = "model.pt"
PROGRAM_FILE = "model.pt2"
PROGRAM_ERROR_FILE = "pt2_export_error.txt"


class _Inference(torch.nn.Module):
    """The detector's inference forward as a function of the images: the
    decoded ``pred`` (or the per-level ``train_outs`` without the decode),
    as the JAX package's exported ``fwd`` returns."""

    def __init__(self, model: torch.nn.Module, with_decode: bool):
        super().__init__()
        self.model, self.with_decode = model, with_decode

    def forward(self, rgb, ir=None):
        out = self.model(rgb, ir)
        return out["pred"] if self.with_decode else tuple(out["train_outs"])


def export_program(model: torch.nn.Module, img_size: int = 640,
                   batch_size: int = 1, two_stream: bool = True,
                   with_decode: bool = True,
                   dtype: torch.dtype = torch.float32) -> bytes:
    """``torch.export`` of ``model``'s inference forward on NHWC images
    ``(batch_size, img_size, img_size, 3)`` of ``dtype`` on the model's
    device, saved (``torch.export.save``) into bytes.  The model is traced
    in eval mode (its mode is restored after): the graph is specialised on
    it, and on the kernel flags, which decide which custom ops it holds.
    Counterpart of ``export_stablehlo``."""
    dev = next(model.parameters()).device
    # one tensor per input: ``export`` would take one tensor passed twice
    # for one input
    xs = tuple(torch.zeros(batch_size, img_size, img_size, 3, dtype=dtype,
                           device=dev) for _ in range(1 + two_stream))
    was_training = model.training
    model.eval()
    try:
        ep = torch.export.export(_Inference(model, with_decode), xs)
    finally:
        model.train(was_training)
    live = [n for n in ep.graph.nodes
            if n.target is torch.ops.aten.dropout.default and n.args[2]]
    if live:
        raise AssertionError(f"the exported graph keeps dropout: {live}")
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_program(blob: bytes):
    """The exported program in ``blob`` as a callable module
    (``pred = prog(rgb, ir)``), on the device it was exported on.  The
    custom ops are registered first.  Counterpart of ``load_stablehlo``."""
    from mmidet_tpu_torch.nn import (cem_cuda, fusion_cuda,  # noqa: F401
                                     transformer_cuda)
    return torch.export.load(io.BytesIO(blob)).module()


def export_savedmodel(path: str, model: torch.nn.Module, img_size: int = 640,
                      batch_size: int = 1, two_stream: bool = True,
                      with_decode: bool = True,
                      dtype: torch.dtype = torch.float32,
                      native: bool = False) -> str:
    """``model``'s inference forward as a TF SavedModel at ``path``:
    ``tf.saved_model.load(path).serve(rgb[, ir])`` and its
    ``signatures["serving_default"]`` (output key ``output_0``, or
    ``output_0..2`` without the decode) on NHWC inputs ``(batch_size,
    img_size, img_size, 3)`` of ``dtype`` (f32 or bf16) named ``rgb`` and
    ``ir``.  The graph is that of a BN-folded copy of ``model`` in f32;
    ``model`` is left as it is.  Counterpart of the JAX package's
    ``export_savedmodel`` in its ``native=False`` form, for every row the
    JAX detector takes (``tf_graph``); ``native=True`` (the embedded
    StableHLO program) raises ``ValueError``, as does a quantized
    model."""
    from mmidet_tpu_torch.deploy import tf_graph, tf_proto
    from mmidet_tpu_torch.models.spec import is_two_stream
    if native:
        raise ValueError("export_savedmodel(native=True) embeds the JAX "
                         "package's StableHLO program, which the port has "
                         "no counterpart of; use native=False (plain TF "
                         "graph ops)")
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    if dtype not in names:
        raise ValueError(f"export_savedmodel: dtype {dtype} (f32 or bf16)")
    spec = model.spec
    if two_stream != is_two_stream(spec):
        raise ValueError(f"two_stream={two_stream}, but the model is "
                         f"{'two' if is_two_stream(spec) else 'single'}-"
                         "stream")
    graph = tf_graph.emit_graph(spec, model, img_size, batch_size,
                                with_decode, names[dtype])
    return tf_proto.write_savedmodel(path, graph)


def export_tflite(savedmodel_path: str, out_path: str,
                  native: bool = False) -> str:
    """The SavedModel at ``savedmodel_path`` (one ``export_savedmodel``
    wrote) as a .tflite flatbuffer of builtins at ``out_path``: its graph
    decoded (``tf_proto``) and each node mapped onto its builtin
    (``tflite_fb.convert``; an op with none raises ``ValueError`` naming
    it).  ``native=True`` (StableHLO ops) raises ``ValueError``."""
    from mmidet_tpu_torch.deploy import tf_proto, tflite_fb
    if native:
        raise ValueError("export_tflite(native=True) keeps StableHLO ops, "
                         "which the port does not write; use native=False")
    blob = tflite_fb.encode(tflite_fb.convert(tf_proto.load(
        savedmodel_path)))
    with open(out_path, "wb") as fh:
        fh.write(blob)
    return out_path


def export_deploy_bundle(path: str, model: torch.nn.Module, spec,
                         names: list[str] | None = None,
                         img_size: int = 640, batch_size: int = 1) -> str:
    """Write ``model.json``, ``model.pt`` (``model``'s state dict, on the
    CPU) and ``model.pt2`` (``export_program`` of ``model`` on its device
    at ``img_size``, ``batch_size``; where the trace fails, its traceback
    in ``pt2_export_error.txt`` instead, as the JAX package keeps going
    without its StableHLO) under ``path``; returns ``path``."""
    from mmidet_tpu_torch.models.spec import is_two_stream
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
    for name in (PROGRAM_FILE, PROGRAM_ERROR_FILE):  # a re-export's
        if os.path.exists(os.path.join(path, name)):
            os.remove(os.path.join(path, name))
    try:
        blob = export_program(model, img_size, batch_size,
                              two_stream=is_two_stream(spec))
    except Exception:  # the graph is best-effort; the weights are written
        with open(os.path.join(path, PROGRAM_ERROR_FILE), "w") as fh:
            fh.write(traceback.format_exc())
    else:
        with open(os.path.join(path, PROGRAM_FILE), "wb") as fh:
            fh.write(blob)
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


def main(argv=None, device="cuda"):
    """Export CLI (the reference's ``models/export.py``): weights in, a
    deploy bundle out.  The bundle holds the unfused model, as the JAX
    package's does, so that it also serves as a training init; its
    ``model.pt2`` is that model's graph, traced on ``device`` (the card
    unless the caller asks for the CPU).  ``--onnx`` adds ``model.onnx``,
    the BN-folded model's graph; ``--savedmodel`` adds ``savedmodel/``,
    and ``--tflite`` also ``savedmodel_graph/`` and ``model.tflite``, the
    JAX bundle's paths."""
    import argparse

    from mmidet_tpu_torch.cli.val import (build_model, load_state_dict_file,
                                          spec_by_name)
    from mmidet_tpu_torch.eval.evaluator import eval_device
    from mmidet_tpu_torch.utils.general import set_logging

    p = argparse.ArgumentParser("mmidet-tpu-torch export")
    p.add_argument("--cfg", type=str, default="yolov5l_fuse3_fourier",
                   help="zoo model name or model YAML path")
    p.add_argument("--weights", type=str, default="",
                   help=".pt (a state dict, the port's checkpoint or a "
                        "reference checkpoint) or deploy bundle (blank: "
                        "seeded init)")
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--names", type=str, nargs="*", default=None)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--out", type=str, default="runs/export/bundle")
    p.add_argument("--savedmodel", action="store_true",
                   help="also export a TF SavedModel of plain graph ops "
                        "(written by the port's codec; no TensorFlow at "
                        "export or inference)")
    p.add_argument("--tflite", action="store_true",
                   help="also convert the SavedModel to .tflite (builtins "
                        "only)")
    p.add_argument("--onnx", action="store_true",
                   help="also export an ONNX graph (opset 17; emitted "
                        "structurally, no onnx package needed; see "
                        "deploy/onnx_export.py)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="batch of model.pt2's input (torch.export traces "
                        "static shapes)")
    args = p.parse_args(argv)
    set_logging()
    dev = eval_device(device)
    spec = spec_by_name(args.cfg, args.nc)
    model = build_model(spec, load_state_dict_file(args.weights)
                        if args.weights else None).to(dev)
    path = export_deploy_bundle(args.out, model, spec, names=args.names,
                                img_size=args.img_size,
                                batch_size=args.batch_size)
    have = os.path.isfile(os.path.join(path, PROGRAM_FILE))
    msg = "yes" if have else f"unavailable, see {PROGRAM_ERROR_FILE}"
    print(f"exported deploy bundle -> {path} (torch.export: {msg})")
    if args.savedmodel or args.tflite:
        import shutil

        from mmidet_tpu_torch.models.spec import is_two_stream
        sm = os.path.join(path, "savedmodel")
        export_savedmodel(sm, model, img_size=args.img_size,
                          batch_size=args.batch_size,
                          two_stream=is_two_stream(spec))
        print(f"exported TF SavedModel -> {sm}")
        if args.tflite:
            # the JAX bundle's graph-ops SavedModel, which its TFLite leg
            # converts; the port's one form is that already
            sm_graph = os.path.join(path, "savedmodel_graph")
            shutil.copytree(sm, sm_graph, dirs_exist_ok=True)
            tfl = export_tflite(sm_graph, os.path.join(path, "model.tflite"))
            print(f"exported TFLite -> {tfl}")
    if args.onnx:
        from mmidet_tpu_torch.deploy.onnx_export import export_onnx
        from mmidet_tpu_torch.nn.fuse import fold_batchnorm
        onnx_path = os.path.join(path, "model.onnx")
        # the bundle holds the unfused weights already: fold in place
        export_onnx(spec, fold_batchnorm(model.eval()), args.img_size,
                    onnx_path, use_cem=model.use_cem)
        print(f"exported ONNX (opset 17) -> {onnx_path}")
    return path


if __name__ == "__main__":
    main()
