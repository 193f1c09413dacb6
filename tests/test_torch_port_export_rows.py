"""The SavedModel and TFLite legs of the rows beyond the ONNX leg's:
MambaFusion, C3TR, BottleneckCSP, DWConv, GhostConv, GhostBottleneck,
MixConv2d, CrossConv, Contract, Expand, a bilinear Upsample,
``nn.MaxPool2d`` and ``nn.ZeroPad2d`` (``deploy/tf_graph.py``), against
the JAX package on the CPU at "t" width, 64 px.

The files are loaded by TensorFlow (``serve``, ``serving_default``) and
run by TFLite's interpreter, each against JAX's ``pred`` within
``ONNX_TOL`` (2e-3 of max(1, |ref|), the JAX package's ONNX gate); the
port's numpy runner (``tf_np``) on each decoded file against TensorFlow's
output within 1e-5; every TFLite operator a builtin.  JAX's MambaFusion
scans in another order (``jax.lax.associative_scan``), well inside the
gate.  Each new graph primitive is held against torch alone in
``tests/test_torch_port_export.py`` (``test_new_primitives_match_torch``)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmidet_tpu.models import spec as jspec
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.spec import LayerDef as JaxLayerDef
from mmidet_tpu.models.zoo import dryrun_spec as jax_dryrun
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.deploy import (export, tf_graph, tf_np, tf_proto,
                                     tflite_fb)
from mmidet_tpu_torch.deploy.onnx_export import export_onnx
from mmidet_tpu_torch.models import spec as pspec
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.spec import LayerDef
from mmidet_tpu_torch.models.zoo import (dryrun_spec, single_stream_p6_spec,
                                         single_stream_spec, two_stream_spec)
from mmidet_tpu_torch.nn.fuse import fold_batchnorm

from test_torch_port_export import (IMG, ONNX_TOL, _images,
                                    _is_builtin_only, _rel_err, _shapes,
                                    _t_fourier, tf, tflite_run)  # noqa: F401
from test_torch_port_train import _seeded, _threads  # noqa: F401
from test_torch_port_zoo_layers import _yaml


def _mamba_level(layer_def, spec):
    """The mamba grammar cut to one fusion level: the dryrun grammar's one
    GPT row a MambaFusion row (``tests/test_torch_port_mamba.py``'s train
    case; the four-level grammar's graph is ``emit_graph``'s below, and
    ``chip_smoke.py`` holds yolov5x_mamba's files on the card)."""
    return dataclasses.replace(spec, layers=tuple(
        layer_def(ld.f, ld.n, "MambaFusion" if ld.name == "GPT" else ld.name,
                  ld.args) for ld in spec.layers))


def _case(name):
    """(JAX spec, port spec, two-stream) of a case: one MambaFusion level
    (two Mamba stacks of four layers over 128 tokens, d_model 32), or the
    reference YAML with every row the JAX detector takes beyond the named
    grammars."""
    if name == "mamba":
        return (_mamba_level(JaxLayerDef, jax_dryrun(nc=2)),
                _mamba_level(LayerDef, dryrun_spec(nc=2)), True)
    return jspec.load_yolo_yaml(_yaml()), pspec.load_yolo_yaml(_yaml()), False


@pytest.fixture(scope="module")
def cases():
    """Per case: seeded variables of JAX's BN-folded detector (the kept
    BatchNorms' statistics among them), the port's fused f32 module with
    them bridged, and JAX's jitted forward on them."""
    out = {}
    for i, name in enumerate(("mamba", "yaml")):
        js, ps, two = _case(name)
        jm = JaxDetector(spec=js, aux_mode="off", use_cem=two, fused=True)
        v = jax.tree_util.tree_map(np.asarray, _seeded(_shapes(jm, two),
                                                       20 + i))
        model = TwoStreamDetector(ps, use_cem=two, fused=True)
        from_jax_variables(model, v)
        fwd = jax.jit(lambda v, *x, jm=jm: jm.apply(v, *x, train=False))
        out[name] = (ps, two, model.eval(),
                     lambda *x, fwd=fwd, v=v: fwd(v, *x))
    return out


def _feeds(two: bool, n: int = 2) -> dict:
    rgb, ir = (a[:n] for a in _images(seed=4))
    return {"rgb": rgb, "ir": ir} if two else {"rgb": rgb}


@pytest.mark.parametrize("name", ["mamba", "yaml"])
def test_rows_savedmodel_and_tflite_match_jax(cases, tf, name, tmp_path):
    """``serve``, ``serving_default`` and TFLite against JAX's ``pred``
    (the gaps printed); ``tf_np`` on both decoded files against
    TensorFlow; builtins only; the new ops in the files."""
    _, two, model, jfwd = cases[name]
    feeds = _feeds(two)
    want = np.asarray(jfwd(*feeds.values())["pred"])
    sm = export.export_savedmodel(str(tmp_path / "sm"), model, IMG, 2,
                                  two_stream=two)
    loaded = tf.saved_model.load(sm)
    serve_out = loaded.serve(*feeds.values()).numpy()
    sig = loaded.signatures["serving_default"](
        **{k: tf.constant(v) for k, v in feeds.items()})["output_0"].numpy()
    lite = export.export_tflite(sm, str(tmp_path / "model.tflite"))
    lite_out = tflite_run(tf, lite, feeds)["output_0"]
    gaps = {"serve": _rel_err(serve_out, want),
            "serving_default": _rel_err(sig, want),
            "tflite": _rel_err(lite_out, want)}
    print(f"{name}: max |x - jax| / max(1, |jax|): {gaps}")
    assert max(gaps.values()) < ONNX_TOL, gaps
    body = tf_proto.load(sm)
    assert _rel_err(tf_np.run(body, feeds)["output_0"], serve_out) < 1e-5
    decoded = tflite_fb.load(lite)
    assert _rel_err(tf_np.run(decoded, feeds)["output_0"], lite_out) < 1e-5
    assert _is_builtin_only(tf, lite)
    ops = {n.op for n in body.serve_function().nodes}
    codes = {tflite_fb.BUILTIN_NAMES[c] for c in decoded.opcodes}
    new = {"mamba": ({"ReverseV2", "Exp", "Log", "DepthwiseConv2dNative"},
                     {"REVERSE_V2", "EXP", "LOG", "BATCH_MATMUL"}),
           "yaml": ({"MaxPool", "SpaceToDepth", "DepthToSpace", "Pad"},
                    {"MAX_POOL_2D", "SPACE_TO_DEPTH", "DEPTH_TO_SPACE",
                     "DEPTHWISE_CONV_2D"})}[name]
    assert new[0] <= ops and new[1] <= codes


def test_rows_levels_and_bf16_match_jax(cases, tf, tmp_path):
    """The YAML case: ``with_decode=False`` (its two levels against JAX's
    ``train_outs``, in TensorFlow and ``tf_np``) and a bf16 input (cast to
    f32 first, against JAX's f32 forward on the same bf16 images)."""
    _, _, model, jfwd = cases["yaml"]
    rgb = _feeds(False)["rgb"]
    levels = [np.asarray(t) for t in jfwd(rgb)["train_outs"]]
    sm = export.export_savedmodel(str(tmp_path / "lv"), model, IMG, 2,
                                  two_stream=False, with_decode=False)
    outs = tf.saved_model.load(sm).serve(rgb)
    runner = tf_np.run(tf_proto.load(sm), {"rgb": rgb})
    assert sorted(runner) == ["output_0", "output_1"]
    for i, want in enumerate(levels):
        assert want.shape == (2, 3, IMG // (8 << i), IMG // (8 << i), 7)
        for got in (outs[i].numpy(), runner[f"output_{i}"]):
            assert _rel_err(got, want) < ONNX_TOL
    rgb16 = jnp.asarray(rgb, jnp.bfloat16)
    want16 = np.asarray(jfwd(rgb16.astype(jnp.float32))["pred"])
    sm16 = export.export_savedmodel(str(tmp_path / "bf16"), model, IMG, 2,
                                    two_stream=False, dtype=torch.bfloat16)
    got = tf.saved_model.load(sm16).serve(tf.constant(rgb16)).numpy()
    assert _rel_err(got, want16) < ONNX_TOL
    assert _rel_err(tf_np.run(tf_proto.load(sm16), {
        "rgb": np.asarray(rgb16, np.float32)})["output_0"], got) < 1e-5


def _zoo_spec(grammar):
    """The grammar at "t" width; GPT1's and GPT1_fourier's d_model, which
    the zoo does not scale, scaled as the widths are."""
    if grammar == "single":
        return single_stream_spec("t", nc=2)
    if grammar == "P6":
        return single_stream_p6_spec("t", nc=2)
    if grammar == "fourier":
        return _t_fourier(two_stream_spec)
    spec = two_stream_spec("t", grammar, nc=2)
    return dataclasses.replace(spec, layers=tuple(dataclasses.replace(
        ld, args=(int(ld.args[0] * spec.width_multiple),) + ld.args[1:])
        if ld.name == "GPT1" else ld for ld in spec.layers))


@pytest.mark.parametrize("grammar", ["add", "gpt3", "gpt4", "gpt1",
                                     "fourier", "mamba", "single", "P6"])
def test_emit_graph_takes_every_zoo_grammar(grammar):
    """``emit_graph`` at "t" width, 64 px: ``pred``'s static shape is
    Detect's (B, N, 5 + nc) over every level, every op a primitive both
    writers know."""
    spec = _zoo_spec(grammar)
    two = pspec.is_two_stream(spec)
    model = TwoStreamDetector(spec, use_cem=two).eval()
    graph = tf_graph.emit_graph(spec, model, IMG)
    n_box = sum(len(a) // 2 * (IMG // s) ** 2
                for a, s in zip(spec.anchors, spec.strides))
    assert graph.shapes[graph.outputs[0]] == (1, n_box, 5 + spec.nc)
    assert [n for n, _, _ in graph.inputs] == (["rgb", "ir"] if two
                                               else ["rgb"])
    tf_proto.body_nodes(graph)     # every op has its TF form


def test_export_cli_savedmodel_tflite_on_a_yaml(tf, tmp_path):
    """``export.main`` with ``--savedmodel --tflite`` on the reference
    YAML with every new row, at 64 px on the CPU: both files written,
    each in TensorFlow against the bundle's own module."""
    cfg = tmp_path / "rows.yaml"
    cfg.write_text(yaml.safe_dump(_yaml()))
    out = str(tmp_path / "bundle")
    assert export.main(["--cfg", str(cfg), "--img-size", str(IMG), "--out",
                        out, "--savedmodel", "--tflite"],
                       device="cpu") == out
    assert {"model.json", "model.pt", "savedmodel", "savedmodel_graph",
            "model.tflite"} <= set(os.listdir(out))
    from mmidet_tpu_torch.cli import val
    spec, sd, _ = export.load_deploy_bundle(out)
    model = fold_batchnorm(val.build_model(spec, sd).eval())
    rgb = _feeds(False, 1)["rgb"]
    with torch.no_grad():
        ref = model(torch.from_numpy(rgb))["pred"].numpy()
    got = tf.saved_model.load(os.path.join(out, "savedmodel")).serve(
        rgb).numpy()
    lite = tflite_run(tf, os.path.join(out, "model.tflite"), {"rgb": rgb})
    assert _rel_err(got, ref) < ONNX_TOL
    assert _rel_err(lite["output_0"], ref) < ONNX_TOL


def test_onnx_refuses_a_bilinear_upsample(tmp_path):
    """The ONNX leg keeps the JAX emitter's refusal of a bilinear Upsample
    (``mmidet_tpu/deploy/onnx_export.py:454``), which the TF legs take."""
    spec = single_stream_spec("t", nc=2)
    spec = dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(ld, args=(None, 2, "bilinear"))
        if ld.name == "Upsample" else ld for ld in spec.layers))
    model = fold_batchnorm(TwoStreamDetector(spec, use_cem=False).eval())
    with pytest.raises(ValueError, match="only nearest upsample"):
        export_onnx(spec, model, IMG, str(tmp_path / "b.onnx"),
                    use_cem=False)
    assert tf_graph.emit_graph(spec, model, IMG).outputs


def test_chip_smoke_rows_yaml_is_the_tests_layout():
    """``chip_smoke.py``'s ``ROWS_YAML``, which its ``export_rows_path``
    exports on the card, is this file's all-rows YAML (the script imports
    nothing from ``tests/``)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    loader = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(cs)
    assert yaml.safe_load(cs.ROWS_YAML) == _yaml()
    assert cs.export_rows_spec("rows") == pspec.load_yolo_yaml(_yaml())
