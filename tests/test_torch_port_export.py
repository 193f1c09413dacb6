"""The port's deploy export against the JAX package's: reference-format
checkpoints in (``train.checkpoint.load_torch_checkpoint`` through every
entry point that takes ``--weights``), portable graphs out (K1, K3 and K4
as ``torch.library`` ops, ``export_program``/``load_program``, the ONNX
leg: ``onnx_proto``, ``onnx_export``, ``onnx_np``, and the SavedModel and
TFLite legs: ``tf_graph``, ``tf_proto``, ``tflite_fb``, ``tf_np``, their
files loaded by TensorFlow), on the CPU at "t" width, 64 px."""

import dataclasses
import filecmp
import functools
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmidet_tpu.deploy import export as jax_export
from mmidet_tpu.deploy import onnx_proto as jax_proto
from mmidet_tpu.deploy.onnx_export import export_onnx as jax_export_onnx
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import single_stream_spec as jax_single
from mmidet_tpu.models.zoo import two_stream_spec as jax_two
from mmidet_tpu.train.checkpoint import convert_torch_state_dict
from mmidet_tpu.train.checkpoint import \
    load_torch_checkpoint as jax_load_checkpoint
from mmidet_tpu_torch import hub
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.cli import val
from mmidet_tpu_torch.deploy import (export, onnx_np, onnx_proto, serve,
                                     tf_graph, tf_np, tf_proto, tflite_fb)
from mmidet_tpu_torch.deploy.onnx_export import export_onnx
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.spec import load_yolo_yaml
from mmidet_tpu_torch.models.zoo import single_stream_spec, two_stream_spec
from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda
from mmidet_tpu_torch.nn import transformer_cuda as tc
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.nn.layers import contract, expand
from mmidet_tpu_torch.train import checkpoint

from test_torch_port_cuda import write_reference_checkpoint
from test_torch_port_train import _seeded, _threads  # noqa: F401
from test_torch_port_zoo_layers import _yaml

F32_TOL = dict(rtol=1e-4, atol=1e-4)  # the detector tests' f32 gate
ONNX_TOL = 2e-3  # the JAX package's ONNX gate, relative to max(1, |ref|)
IMG = 64


def _shapes(jmodel, two: bool):
    x = jnp.zeros((1, IMG, IMG, 3))
    return jax.eval_shape(
        lambda k: jmodel.init({"params": k}, x, x if two else None,
                              train=False), jax.random.PRNGKey(0))


def _rel_err(got, ref) -> float:
    """Max error relative to max(1, |ref|): boxes are in pixels, scores in
    [0, 1] (the JAX package's ONNX test)."""
    assert got.shape == ref.shape
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.fixture(scope="module")
def tf():
    """TensorFlow (only the tests import it; a skip without it), its
    threads capped to torch's, which the module's autouse fixture has set
    first, and its graph
    optimizer off while the module runs: the files are run as written,
    and each function's first call costs a third of the time."""
    tf = pytest.importorskip("tensorflow")
    n = torch.get_num_threads()
    try:
        tf.config.threading.set_intra_op_parallelism_threads(n)
        tf.config.threading.set_inter_op_parallelism_threads(n)
    except RuntimeError:   # its runtime started already in this process
        pass
    before = tf.config.optimizer.get_experimental_options()
    tf.config.optimizer.set_experimental_options(
        {"disable_meta_optimizer": True})
    yield tf
    tf.config.optimizer.set_experimental_options(
        {"disable_meta_optimizer": before.get("disable_meta_optimizer",
                                              False)})


def tflite_run(tf, path: str, feeds: dict) -> dict:
    interp = tf.lite.Interpreter(path, num_threads=torch.get_num_threads())
    return interp.get_signature_runner("serving_default")(**feeds)


def check_tf_bundle(tf, out: str, folded, rgb, ir) -> dict:
    """The export CLI's ``--savedmodel --tflite`` legs: the JAX bundle's
    paths (``savedmodel_graph/`` the same files as ``savedmodel/``: the
    port writes the graph-ops form only), and TensorFlow's output of the
    SavedModel and the .tflite against ``folded``'s forward within
    ONNX_TOL; returns the gaps."""
    assert {"savedmodel", "savedmodel_graph", "model.tflite"} <= set(
        os.listdir(out))
    for f in ("saved_model.pb", "variables/variables.index",
              "variables/variables.data-00000-of-00001"):
        assert filecmp.cmp(os.path.join(out, "savedmodel", f),
                           os.path.join(out, "savedmodel_graph", f),
                           shallow=False)
    with torch.no_grad():
        ref = folded(rgb, ir)["pred"].numpy()
    rgb, ir = rgb.numpy(), ir.numpy()
    gaps = {"savedmodel": _rel_err(tf.saved_model.load(os.path.join(
        out, "savedmodel")).serve(rgb, ir).numpy(), ref)}
    gaps["tflite"] = _rel_err(tflite_run(tf, os.path.join(
        out, "model.tflite"), {"rgb": rgb, "ir": ir})["output_0"], ref)
    assert max(gaps.values()) < ONNX_TOL, gaps
    return gaps


def _images(n=2, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32))


# --------------------------------------------------- reference checkpoints

@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A reference-format checkpoint of yolov5t_add (nc 2): pickled stub
    ``models.yolo.Model`` objects, fp16, ``model`` and an ``ema`` that
    differs from it, written from a reference checkout made here."""
    spec = two_stream_spec("t", "add", nc=2)
    jmodel = JaxDetector(spec=jax_two("t", "add", nc=2), aux_mode="off")
    shapes = _shapes(jmodel, True)
    sds = []
    for seed in (3, 4):  # model, then ema
        m = TwoStreamDetector(spec)
        from_jax_variables(m, jax.tree_util.tree_map(
            np.asarray, _seeded(shapes, seed)))
        sds.append(m.state_dict())
    path, repo = write_reference_checkpoint(
        tmp_path_factory.mktemp("refckpt"), *sds)
    want = {k: v.half().float() if v.is_floating_point() else v
            for k, v in sds[1].items()}
    return {"path": path, "repo": repo, "spec": spec, "want": want,
            "jmodel": jmodel, "shapes": shapes}


@pytest.fixture
def fresh_imports(monkeypatch):
    """Each load imports the stub checkout anew: ``models`` is dropped
    from ``sys.modules`` and ``sys.path`` restored after."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in [n for n in sys.modules
                 if n == "models" or n.startswith("models.")]:
        monkeypatch.delitem(sys.modules, name)
    yield
    for name in ("models.yolo", "models"):
        sys.modules.pop(name, None)


def test_reference_checkpoint_matches_jax(ref_ckpt, fresh_imports):
    """The port's loader against JAX's ``load_torch_checkpoint`` +
    ``convert_torch_state_dict``: the same tensors (EMA, fp16 -> f32), and
    the two forwards on them agree."""
    path, repo = ref_ckpt["path"], ref_ckpt["repo"]
    with pytest.raises(pickle.UnpicklingError):  # a pickle of modules
        torch.load(path, weights_only=True)
    sd = checkpoint.load_torch_checkpoint(path, reference_repo=repo)
    want = ref_ckpt["want"]
    assert list(sd) == list(want)
    assert all(sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k])
               for k in want)
    model_sd = checkpoint.load_torch_checkpoint(path, reference_repo=repo,
                                                prefer_ema=False)
    assert not torch.equal(model_sd["model.0.conv.conv.weight"],
                           sd["model.0.conv.conv.weight"])
    jsd = jax_load_checkpoint(path, reference_repo=repo)
    assert list(jsd) == list(sd)
    assert all(np.array_equal(jsd[k], sd[k].numpy()) for k in sd)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(ref_ckpt["shapes"]))
    v = convert_torch_state_dict(template, jsd, strict=True)
    rgb, ir = _images()
    jmodel = ref_ckpt["jmodel"]
    want_pred = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False)["pred"])(v, rgb, ir))
    model = val.build_model(ref_ckpt["spec"], sd).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(ir))["pred"]
    np.testing.assert_allclose(got.numpy(), want_pred, **F32_TOL)


class _Stop(Exception):
    pass


def test_reference_checkpoint_through_every_entry_point(
        ref_ckpt, fresh_imports, tmp_path, monkeypatch, tf):
    """val (and detect, which loads through it), serve, the hub and the
    export CLI read the file with no reference checkout named, as the JAX
    package's val does, once its classes import; the trainer's
    ``weights`` names the checkout by ``MMIDET_REFERENCE_REPO``."""
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.train import trainer
    path, repo, want = ref_ckpt["path"], ref_ckpt["repo"], ref_ckpt["want"]
    # the trainer: the checkout named by the environment
    got, real = [], trainer.transfer_matching

    def transfer(m, loaded):
        got.append((real(m, loaded), loaded))
        raise _Stop
    monkeypatch.setattr(trainer, "transfer_matching", transfer)
    monkeypatch.setenv("MMIDET_REFERENCE_REPO", repo)
    data = make_synthetic_pair_dataset(str(tmp_path / "d"), n=2, img=IMG)
    cfg = trainer.TrainConfig(model="yolov5t_add", data=data, weights=path,
                              epochs=1, batch_size=2, img_size=IMG,
                              mosaic_prob=0.0, dtype="float32",
                              workdir=str(tmp_path / "run"))
    with pytest.raises(_Stop):
        trainer.train(cfg, device="cpu")
    (n_copied, n_total), loaded = got[0]
    assert n_copied == n_total > 100
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    assert repo in sys.path and "thop" in sys.modules
    # the classes import now: val, serve, the hub and export need no repo
    folded = fold_batchnorm(val.build_model(ref_ckpt["spec"], want).eval())
    model, _ = val.load_model_and_vars("yolov5t_add", path, 2, device="cpu")
    assert all(torch.equal(v, folded.state_dict()[k])
               for k, v in model.state_dict().items())
    chosen = []
    monkeypatch.setattr(serve, "serve", lambda svc, *a: chosen.append(svc))
    svc = serve.main(["--cfg", "yolov5t_add", "--nc", "2", "--weights",
                      path, "--img-size", str(IMG), "--no-batching"],
                     device="cpu")
    assert chosen == [svc]
    m = hub._make("yolov5t_add", 2, weights=path, img_size=IMG,
                  device="cpu")
    assert all(torch.equal(v, folded.state_dict()[k])
               for k, v in m.model.state_dict().items())
    out = str(tmp_path / "bundle")
    assert export.main(["--cfg", "yolov5t_add", "--nc", "2", "--weights",
                        path, "--img-size", str(IMG), "--out", out,
                        "--onnx", "--savedmodel", "--tflite"],
                       device="cpu") == out
    assert sorted(os.listdir(out)) == ["model.json", "model.onnx", "model.pt",
                                       "model.pt2", "model.tflite",
                                       "savedmodel", "savedmodel_graph"]
    bundle_sd = val.load_state_dict_file(out)
    assert all(torch.equal(bundle_sd[k], want[k]) for k in want)
    rgb, ir = (torch.from_numpy(a[:1]) for a in _images())
    graph = onnx_proto.Model.load(os.path.join(out, "model.onnx")).graph
    with torch.no_grad():
        ref = folded(rgb, ir)["pred"].numpy()
    assert _rel_err(onnx_np.run(graph, {
        "rgb": rgb.permute(0, 3, 1, 2).numpy(),
        "ir": ir.permute(0, 3, 1, 2).numpy()})["pred"], ref) < ONNX_TOL
    # the SavedModel and TFLite legs, run by TensorFlow
    check_tf_bundle(tf, out, folded, rgb, ir)


# ------------------------------------------------------------------ ONNX

def test_onnx_codec_matches_jax():
    """The port's encode of the JAX test's graph decodes to the same nodes,
    attributes, shapes and initializers under both codecs, and back."""
    def graph(mod):
        w = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        return mod.Graph(
            "g", nodes=[mod.Node("Conv", ["x", "w"], ["y"], name="c",
                                 attrs={"strides": [2, 2],
                                        "pads": [1, 1, 1, 1], "group": 1,
                                        "alpha": 0.1, "mode": "nearest",
                                        "scales": [1.0, 2.0]}),
                        mod.Node("Sigmoid", ["y"], ["z"], name="s")],
            inputs=[mod.ValueInfo("x", mod.FLOAT, ("batch", 3, 8, 8))],
            outputs=[mod.ValueInfo("z", mod.FLOAT, ("batch", 2, 4, 4))],
            initializers=[mod.Tensor("w", w),
                          mod.Tensor("i", np.asarray([-1, 0, 7], np.int64))])
    buf = onnx_proto.Model(graph(onnx_proto), doc="rt").encode()
    assert buf == jax_proto.Model(graph(jax_proto), doc="rt",
                                  producer="mmidet_tpu_torch").encode()
    for mod in (onnx_proto, jax_proto):
        m = mod.Model.decode(buf)
        assert m.opset == 17 and m.producer == "mmidet_tpu_torch"
        g = m.graph
        assert [(n.op_type, n.inputs, n.outputs, n.name) for n in g.nodes] \
            == [("Conv", ["x", "w"], ["y"], "c"), ("Sigmoid", ["y"], ["z"],
                                                   "s")]
        a = g.nodes[0].attrs
        assert a["strides"] == [2, 2] and a["pads"] == [1, 1, 1, 1]
        assert a["group"] == 1 and a["mode"] == "nearest"
        assert abs(a["alpha"] - 0.1) < 1e-7 and a["scales"] == [1.0, 2.0]
        assert g.inputs[0].shape == ("batch", 3, 8, 8)
        np.testing.assert_array_equal(g.initializers[1].array, [-1, 0, 7])
        assert g.initializers[0].array.dtype == np.float32


def _t_fourier(make):
    """The fourier grammar at "t" width and JAX's ONNX test's depth 0.25:
    GPT1_fourier's d_model, which the zoo does not scale (it builds the
    grammar at l width), scaled here as the widths are."""
    spec = make("t", "fourier", nc=2, fusion_layers=1)
    layers = tuple(dataclasses.replace(
        ld, args=(int(ld.args[0] * spec.width_multiple),) + ld.args[1:])
        if ld.name == "GPT1_fourier" else ld for ld in spec.layers)
    return dataclasses.replace(spec, layers=layers, depth_multiple=0.25)


def _case(name):
    """(JAX spec, port spec, two-stream) of an ONNX case."""
    if name == "single":
        return jax_single("t", nc=2), single_stream_spec("t", nc=2), False
    if name == "fourier":
        return _t_fourier(jax_two), _t_fourier(two_stream_spec), True
    layers = {"add": {}, "gpt4": {"fusion_layers": 2}}[name]
    return (jax_two("t", name, nc=2, **layers),
            two_stream_spec("t", name, nc=2, **layers), True)


@pytest.fixture(scope="module")
def folded_cases():
    """Per case: seeded variables of JAX's BN-folded model (``fused``:
    what ``fold_batchnorm`` gives), and the port's fused f32 module with
    them bridged onto it."""
    out = {}
    for i, name in enumerate(("add", "gpt4", "fourier", "single")):
        jspec, pspec, two = _case(name)
        jmodel = JaxDetector(spec=jspec, aux_mode="off", use_cem=two,
                             fused=True)
        folded = jax.tree_util.tree_map(np.asarray, _seeded(
            _shapes(jmodel, two), 10 + i))
        model = TwoStreamDetector(pspec, use_cem=two, fused=True)
        from_jax_variables(model, folded)
        out[name] = (jspec, pspec, two, folded, model.eval())
    return out


@pytest.mark.parametrize("name", ["add", "gpt4", "fourier", "single"])
def test_onnx_graph_matches_jax(folded_cases, name, tmp_path):
    """The same node sequence, op types, attributes, names, inputs and
    outputs as JAX's emitter, initializers equal to the bit; the file run
    by the port's numpy runner against the port's f32 forward."""
    jspec, pspec, two, folded, model = folded_cases[name]
    jax_export_onnx(jspec, folded, IMG, str(tmp_path / "j.onnx"),
                    use_cem=two)
    export_onnx(pspec, model, IMG, str(tmp_path / "p.onnx"), use_cem=two)
    want = onnx_proto.Model.load(str(tmp_path / "j.onnx")).graph
    got = onnx_proto.Model.load(str(tmp_path / "p.onnx")).graph
    assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs)
            for n in got.nodes] == [(n.op_type, n.inputs, n.outputs, n.name,
                                     n.attrs) for n in want.nodes]
    assert [(v.name, v.shape) for v in got.inputs + got.outputs] == \
        [(v.name, v.shape) for v in want.inputs + want.outputs]
    assert [t.name for t in got.initializers] == \
        [t.name for t in want.initializers]
    assert all(a.array.dtype == b.array.dtype
               and np.array_equal(a.array, b.array)
               for a, b in zip(got.initializers, want.initializers))
    rgb, ir = _images()
    feeds = {"rgb": rgb.transpose(0, 3, 1, 2),
             "ir": ir.transpose(0, 3, 1, 2)} if two else \
        {"images": rgb.transpose(0, 3, 1, 2)}
    pred = onnx_np.run(got, feeds)["pred"]
    with torch.no_grad():
        ref = model(torch.from_numpy(rgb),
                    torch.from_numpy(ir) if two else None)["pred"].numpy()
    assert _rel_err(pred, ref) < ONNX_TOL


def test_onnx_refuses_mamba(folded_cases, tmp_path):
    """Both emitters refuse a MambaFusion row.  The mamba grammar is the
    gpt4 one with MambaFusion at each level, so JAX's emitter reaches its
    first MambaFusion row on the gpt4 case's variables.  The port's
    emitter refuses the rows only the YAML grammar names too (the JAX
    emitter's catch-all, ``mmidet_tpu/deploy/onnx_export.py:470``), which
    the TF legs take: the reference YAML's first, ``nn.ZeroPad2d``."""
    with pytest.raises(ValueError, match="MambaFusion"):
        jax_export_onnx(jax_two("t", "mamba", nc=2), folded_cases["gpt4"][3],
                        IMG, str(tmp_path / "j.onnx"))
    model = fold_batchnorm(TwoStreamDetector(two_stream_spec("t", "mamba",
                                                             nc=2)))
    with pytest.raises(ValueError, match="MambaFusion"):
        export_onnx(two_stream_spec("t", "mamba", nc=2), model, IMG,
                    str(tmp_path / "p.onnx"))
    rows = load_yolo_yaml(_yaml())
    with pytest.raises(ValueError, match="nn.ZeroPad2d"):
        export_onnx(rows, fold_batchnorm(TwoStreamDetector(
            rows, use_cem=False)), IMG, str(tmp_path / "y.onnx"),
            use_cem=False)


# ------------------------------------------------------ the ops, exported

def _stack(d, L, gen):
    def mat(o, i):
        return torch.randn(L, o, i, generator=gen) / i ** 0.5

    def vec(n, base=0.0):
        return base + 0.2 * torch.randn(L, n, generator=gen)
    return {"ln1_scale": vec(d, 1.0), "ln1_bias": vec(d), "wq": mat(d, d),
            "wk": mat(d, d), "wv": mat(d, d), "bq": vec(d), "bk": vec(d),
            "bv": vec(d), "wo": mat(d, d), "bo": vec(d),
            "ln2_scale": vec(d, 1.0), "ln2_bias": vec(d),
            "w1": mat(4 * d, d), "b1": vec(4 * d), "w2": mat(d, 4 * d),
            "b2": vec(d)}


def _cem_params(gen):
    return (0.2 * torch.randn(3, 3, 3, 24, generator=gen),
            0.1 * torch.randn(24, generator=gen),
            torch.randn(24, generator=gen),
            0.1 * torch.randn(24, generator=gen),
            0.1 * torch.randn(3, 3, 24, 3, generator=gen),
            0.1 * torch.randn(3, generator=gen))


def op_cases(gen, device="cpu"):
    """(op, args) for ``torch.library.opcheck``: K1, K4 gated and not, K3
    in f32 with the weights and in bf16 with its pack."""
    d = 16
    ws = tc.prepare_stack(_stack(d, 2, gen), device)
    stack = [ws[k] for k in tc.STACK_KEYS]
    rgb, ir = (torch.rand(2, 9, 11, d, generator=gen).to(device)
               for _ in range(2))
    pos = (0.2 * torch.randn(1, 128, d, generator=gen)).to(device)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    g1, g2 = (torch.randn(d, 8, generator=gen).to(device),
              torch.randn(8, d, generator=gen).to(device))
    cem = [t.to(device) for t in _cem_params(gen)]
    x = torch.rand(2, 10, 12, 3, generator=gen).to(device)
    return {"K1": (tc.token_transformer_op,
                   (torch.randn(2, 128, d, generator=gen).to(device), stack,
                    2)),
            "K4_gated": (fusion_cuda.gpt_merge_op,
                         (rgb, ir, stack, pos, *ln, 2, g1, g2)),
            "K4": (fusion_cuda.gpt_merge_op,
                   (rgb, ir, stack, pos, *ln, 2, None, None)),
            "K3_f32": (cem_cuda.cem_op, (x, *cem, None)),
            "K3_bf16": (cem_cuda.cem_op, (
                x.bfloat16(), *cem,
                cem_cuda.pack_cem_weights(*cem, torch.bfloat16)))}


@pytest.mark.parametrize("case", ["K1", "K4_gated", "K4", "K3_f32",
                                  "K3_bf16"])
def test_opcheck_on_the_cpu(case):
    """Schema, fake implementation (shapes, dtypes, strides), autograd
    registration and AOT dispatch of each custom op; its CPU
    implementation is the plain version, which the public wrapper gives."""
    op, args = op_cases(torch.Generator().manual_seed(0))[case]
    torch.library.opcheck(op, args)
    assert op._qualname.startswith("mmidet::")


def test_packing_traces_as_tensor_code():
    """The kernel-ready weights (``pack_cem_weights``, ``prepare_stack``)
    are plain tensor ops: ``torch.export`` traces them into a graph that
    gives what the eager call gives."""
    gen = torch.Generator().manual_seed(1)
    cem = _cem_params(gen)
    st = _stack(8, 2, gen)

    class Pack(torch.nn.Module):
        def forward(self, *ts):
            ws = tc.prepare_stack(dict(zip(st, ts[6:])), ts[0].device)
            return (cem_cuda.pack_cem_weights(*ts[:6], torch.bfloat16),
                    *[ws[k] for k in tc.STACK_KEYS])
    args = (*cem, *st.values())
    ep = torch.export.export(Pack(), args)
    for got, want in zip(ep.module()(*args), Pack()(*args)):
        assert torch.equal(got, want)


def _ops_in(prog) -> list[str]:
    return [str(n.target) for n in prog.graph.nodes
            if str(n.target).startswith("mmidet.")]


@pytest.mark.parametrize("name", ["gpt4", "fourier"])
def test_export_program_round_trip(folded_cases, name):
    """``export_program``/``load_program`` of a BN-folded model on its
    kernel routes: the graph holds the custom ops (K1 at every fusion
    level; K3 once and K4 at every level) and no dropout, and the loaded
    program's ``pred`` is the eager module's to the bit."""
    _, pspec, _, _, model = folded_cases[name]
    flags = {"kernel_fusion": True} if name == "gpt4" else {
        "kernel_cem": True, "kernel_merge": True}
    routed = TwoStreamDetector(pspec, fused=True, **flags).eval()
    routed.load_state_dict(model.state_dict())
    blob = export.export_program(routed, IMG, 2)
    assert not routed.training
    prog = export.load_program(blob)
    want = ["mmidet.fused_token_transformer.default"] * 4 \
        if name == "gpt4" else ["mmidet.fused_cem.default"] + \
        ["mmidet.fused_gpt_merge.default"] * 4
    assert _ops_in(prog) == want
    assert not any("dropout" in str(n.target) for n in prog.graph.nodes)
    rgb, ir = (torch.from_numpy(a) for a in _images(seed=5))
    with torch.no_grad():
        assert torch.equal(prog(rgb, ir), routed(rgb, ir)["pred"])


# ------------------------------------------------- SavedModel and TFLite

@pytest.fixture(scope="module")
def jax_forward(folded_cases):
    """``f(name)``: JAX's BN-folded forward of a case, jitted once a case:
    ``f(name)(rgb[, ir])`` -> the ``apply`` output dict (``pred`` and
    ``train_outs``)."""
    fns = {}

    def get(name):
        if name not in fns:
            jspec, _, two, folded, _ = folded_cases[name]
            jm = JaxDetector(spec=jspec, aux_mode="off", use_cem=two,
                             fused=True)
            fn = jax.jit(lambda v, *x: jm.apply(v, *x, train=False))
            fns[name] = functools.partial(fn, folded)
        return fns[name]
    return get


def _is_builtin_only(tf, path: str) -> bool:
    """TensorFlow's own schema reader: no CUSTOM operator code (so no
    Flex op either), and every code one of the builtins the port
    writes."""
    from tensorflow.lite.python import schema_py_generated as schema
    with open(path, "rb") as fh:
        m = schema.Model.GetRootAs(fh.read(), 0)
    codes = [m.OperatorCodes(i) for i in range(m.OperatorCodesLength())]
    return all(c.CustomCode() is None
               and c.BuiltinCode() != schema.BuiltinOperator.CUSTOM
               and c.BuiltinCode() in tflite_fb.BUILTIN_NAMES
               for c in codes)


@pytest.mark.parametrize("name", ["add", "gpt4", "fourier", "single"])
def test_savedmodel_and_tflite_match_jax(folded_cases, jax_forward, tf, name,
                                         tmp_path):
    """``export_savedmodel`` loaded by ``tf.saved_model.load`` (``serve``
    and ``serving_default``) and ``export_tflite`` run by TFLite's
    interpreter against JAX's ``pred`` within ONNX_TOL (the gaps are
    printed); ``tf_np`` on both decoded files against TensorFlow within
    1e-5; only builtins in the .tflite; the exported module unchanged."""
    _, _, two, _, model = folded_cases[name]
    rgb, ir = _images()
    feeds = {"rgb": rgb, "ir": ir} if two else {"rgb": rgb}
    want = np.asarray(jax_forward(name)(*feeds.values())["pred"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sm = export.export_savedmodel(str(tmp_path / "sm"), model, IMG, 2,
                                  two_stream=two)
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    loaded = tf.saved_model.load(sm)
    serve_out = loaded.serve(*feeds.values()).numpy()
    sig = loaded.signatures["serving_default"](
        **{k: tf.constant(v) for k, v in feeds.items()})
    assert list(sig) == ["output_0"]
    lite = export.export_tflite(sm, str(tmp_path / "model.tflite"))
    lite_out = tflite_run(tf, lite, feeds)["output_0"]
    gaps = {"serve": _rel_err(serve_out, want),
            "serving_default": _rel_err(sig["output_0"].numpy(), want),
            "tflite": _rel_err(lite_out, want)}
    print(f"{name}: max |x - jax| / max(1, |jax|): {gaps}")
    assert max(gaps.values()) < ONNX_TOL, gaps
    assert _rel_err(tf_np.run(tf_proto.load(sm), feeds)["output_0"],
                    serve_out) < 1e-5
    decoded = tflite_fb.load(lite)
    assert _rel_err(tf_np.run(decoded, feeds)["output_0"], lite_out) < 1e-5
    assert _is_builtin_only(tf, lite)
    assert decoded.opcodes and set(decoded.opcodes) <= set(
        tflite_fb.BUILTIN_NAMES)


def test_savedmodel_signature_matches_jax(folded_cases, tf, tmp_path,
                                          monkeypatch):
    """The ``add`` case: the port's SavedModel has the input names, dtypes
    and shapes and the output keys of the JAX package's own
    ``export_savedmodel(..., native=False)``, in ``serve`` and in
    ``serving_default``, and the two give the same ``pred``.  JAX's
    ``tf.function`` runs without autograph here: a ``jax2tf`` function
    has no Python control flow on tensors for it to convert, and its
    attempt takes about 13 s."""
    monkeypatch.setattr(tf, "function",
                        functools.partial(tf.function, autograph=False))
    jspec, _, _, folded, model = folded_cases["add"]
    jm = JaxDetector(spec=jspec, aux_mode="off", use_cem=True, fused=True)
    theirs = tf.saved_model.load(jax_export.export_savedmodel(
        str(tmp_path / "jax"), jm, folded, img_size=IMG, batch_size=2,
        native=False))
    path = export.export_savedmodel(str(tmp_path / "port"), model, IMG, 2)
    ours = tf.saved_model.load(path)
    sa, sb = (m.signatures["serving_default"] for m in (ours, theirs))
    assert sa.structured_input_signature == sb.structured_input_signature
    assert sa.structured_outputs == sb.structured_outputs
    assert [(s.name, s.dtype, s.shape) for s in
            ours.serve.concrete_functions[0].structured_input_signature[0]] \
        == [(s.name, s.dtype, s.shape) for s in
            theirs.serve.concrete_functions[0].structured_input_signature[0]]
    # the port's decoder: the tag, and the top-level graph TF Serving
    # reads through the SignatureDef
    decoded = tf_proto.load(path)
    assert decoded.tags == ["serve"]
    assert [n.op for n in decoded.graph_nodes] == [
        "Placeholder", "Placeholder", "PartitionedCall"]
    assert {k: v[0] for k, v in decoded.signatures[
        "serving_default"].inputs.items()} == {
        "ir": "serving_default_ir:0", "rgb": "serving_default_rgb:0"}
    rgb, ir = _images()
    got, want = ours.serve(rgb, ir).numpy(), theirs.serve(rgb, ir).numpy()
    assert _rel_err(got, want) < ONNX_TOL
    got = ours.signatures["serving_default"](rgb=tf.constant(rgb),
                                             ir=tf.constant(ir))
    assert _rel_err(got["output_0"].numpy(), want) < ONNX_TOL


def test_savedmodel_levels_and_bf16_match_jax(folded_cases, jax_forward,
                                              tf, tmp_path):
    """``with_decode=False``: the three levels' (B, na, ny, nx, no)
    outputs (keys ``output_0..2``) against JAX's ``train_outs``;
    ``dtype=torch.bfloat16``: bf16 inputs, cast to f32 first, against
    JAX's ``pred`` on the same bf16 images (whose first op is that cast,
    ``rgb.astype(self.dtype)``, ``mmidet_tpu/models/detector.py:74``, so
    its f32 forward on the cast images is its bf16 forward); the numpy
    runner on both.  TFLite takes no bf16 input: it refuses."""
    model = folded_cases["add"][4]
    rgb, ir = _images()
    rgb16, ir16 = (jnp.asarray(a, jnp.bfloat16) for a in (rgb, ir))
    jf = jax_forward("add")
    levels = [np.asarray(t) for t in jf(rgb, ir)["train_outs"]]
    want16 = np.asarray(jf(rgb16.astype(jnp.float32),
                           ir16.astype(jnp.float32))["pred"])
    sm = export.export_savedmodel(str(tmp_path / "lv"), model, IMG, 2,
                                  with_decode=False)
    loaded = tf.saved_model.load(sm)
    outs = loaded.serve(rgb, ir)
    sig = loaded.signatures["serving_default"](rgb=tf.constant(rgb),
                                               ir=tf.constant(ir))
    assert sorted(sig) == ["output_0", "output_1", "output_2"]
    runner = tf_np.run(tf_proto.load(sm), {"rgb": rgb, "ir": ir})
    for i, want in enumerate(levels):
        assert outs[i].shape == want.shape == (2, 3, IMG // 2 ** (3 + i),
                                               IMG // 2 ** (3 + i), 7)
        for got in (outs[i].numpy(), sig[f"output_{i}"].numpy(),
                    runner[f"output_{i}"]):
            assert _rel_err(got, want) < ONNX_TOL
    sm16 = export.export_savedmodel(str(tmp_path / "bf16"), model, IMG, 2,
                                    dtype=torch.bfloat16)
    loaded = tf.saved_model.load(sm16)
    specs = loaded.signatures["serving_default"].structured_input_signature
    assert {s.dtype for s in specs[1].values()} == {tf.bfloat16}
    f16 = {k: np.asarray(v, np.float32) for k, v in
           (("rgb", rgb16), ("ir", ir16))}
    got = loaded.serve(tf.constant(rgb16), tf.constant(ir16)).numpy()
    assert _rel_err(got, want16) < ONNX_TOL
    assert _rel_err(tf_np.run(tf_proto.load(sm16), f16)["output_0"],
                    got) < 1e-5
    with pytest.raises(ValueError, match="bfloat16"):
        export.export_tflite(sm16, str(tmp_path / "bf16.tflite"))


def test_tf_primitives_match_torch(tf, tmp_path):
    """The primitives no zoo case reaches: a depthwise conv (its padding
    SAME in one dimension, a ``Pad`` node in the other), hardswish, relu
    and div, written, converted and run by TensorFlow, TFLite and
    ``tf_np`` against torch's forward."""
    from mmidet_tpu_torch.deploy import tf_graph
    gen = torch.Generator().manual_seed(3)
    w, b = torch.randn(6, 1, 3, 3, generator=gen), torch.randn(6,
                                                               generator=gen)
    x = torch.randn(2, 9, 10, 6, generator=gen)
    g = tf_graph.Emitter()
    g.shapes["rgb"], g.dtypes["rgb"] = tuple(x.shape), "float32"
    y = g.act(g.conv("rgb", w.numpy(), b.numpy(), stride=2,
                     pads=(1, 1, 1, 1), groups=6), "hardswish")
    y = g.op("div", [g.act(y, "relu"), g.const("c", np.float32(3.0))])
    graph = tf_graph.TFGraph([("rgb", tuple(x.shape), "float32")], [y],
                             g.ops, g.consts, g.shapes, g.dtypes)
    sm = tf_proto.write_savedmodel(str(tmp_path / "sm"), graph)
    lite = export.export_tflite(sm, str(tmp_path / "p.tflite"))
    ref = torch.relu(torch.nn.functional.hardswish(torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w, b, stride=2, padding=1, groups=6))) / 3
    feeds = {"rgb": x.numpy()}
    assert "DEPTHWISE_CONV_2D" in {
        tflite_fb.BUILTIN_NAMES[c] for c in tflite_fb.load(lite).opcodes}
    for got in (tf.saved_model.load(sm).serve(x.numpy()).numpy(),
                tflite_run(tf, lite, feeds)["output_0"],
                tf_np.run(tf_proto.load(sm), feeds)["output_0"],
                tf_np.run(tflite_fb.load(lite), feeds)["output_0"]):
        np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-5, atol=1e-5)


def _prim_graph(x_shape, build):
    g = tf_graph.Emitter()
    g.shapes["rgb"], g.dtypes["rgb"] = tuple(x_shape), "float32"
    y = build(g, "rgb")
    return tf_graph.TFGraph([("rgb", tuple(x_shape), "float32")], [y],
                            g.ops, g.consts, g.shapes, g.dtypes)


def _nchw(fn):
    """An NCHW torch function on NHWC tensors."""
    return lambda x: fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _primitive_cases():
    """(input NHWC shape, emitter, torch reference, the TFLite builtin it
    must map to) a new primitive."""
    gen = torch.Generator().manual_seed(5)
    w_g = torch.randn(6, 2, 3, 3, generator=gen)        # 2 groups of 2 in
    w_m = torch.randn(8, 1, 5, 5, generator=gen)        # multiplier 2
    w_x = torch.randn(5, 4, 1, 3, generator=gen)        # (1, 3), (1, 2)
    b = torch.randn(8, generator=gen)
    return {
        "max_pool_padded": (
            (2, 9, 9, 4),
            lambda g, x: tf_graph._max_pool_row(
                g, x, types.SimpleNamespace(args=(3, 2, 1))),
            _nchw(lambda x: F.max_pool2d(x, 3, 2, 1)), "PADV2"),
        "zero_pad_max_pool": (
            (2, 7, 7, 4),
            lambda g, x: g.op("max_pool", [g.pad(x, 0, 1, 0, 1)], k=2,
                              stride=1, padding="VALID"),
            _nchw(lambda x: F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)),
            "MAX_POOL_2D"),
        "grouped_conv": (
            (2, 8, 9, 4),
            lambda g, x: g.conv(x, w_g.numpy(), b[:6].numpy(), stride=2,
                                pads=(1, 1, 1, 1), groups=2),
            _nchw(lambda x: F.conv2d(x, w_g, b[:6], 2, 1, groups=2)),
            "CONV_2D"),
        "depthwise_multiplier": (
            (2, 8, 8, 4),
            lambda g, x: g.conv(x, w_m.numpy(), b.numpy(), pads=(2, 2, 2, 2),
                                groups=4),
            _nchw(lambda x: F.conv2d(x, w_m, b, 1, 2, groups=4)),
            "DEPTHWISE_CONV_2D"),
        "non_square_conv": (
            (2, 7, 10, 4),
            lambda g, x: g.conv(x, w_x.numpy(), None, stride=(1, 2),
                                pads=(0, 1, 0, 1)),
            _nchw(lambda x: F.conv2d(x, w_x, None, (1, 2), (0, 1))),
            "CONV_2D"),
        "softplus": (
            (2, 3, 4, 8),
            lambda g, x: tf_graph._softplus(g, g.const_mul(x, 30.0)),
            lambda x: torch.logaddexp(30.0 * x, torch.zeros(())), "LOG"),
        "reverse": (
            (2, 5, 6, 3),
            lambda g, x: g.op("exp", [g.op("reverse", [x], axis=1)]),
            lambda x: torch.exp(x.flip(1)), "REVERSE_V2"),
        "space_to_depth": (
            (2, 8, 6, 3),
            lambda g, x: g.op("space_to_depth", [x], block=2),
            _nchw(lambda x: contract(x, 2)), "SPACE_TO_DEPTH"),
        "depth_to_space": (
            (2, 4, 3, 12),
            lambda g, x: g.op("depth_to_space", [x], block=2),
            _nchw(lambda x: expand(x, 2)), "DEPTH_TO_SPACE"),
        "bilinear": (
            (2, 5, 6, 3),
            lambda g, x: tf_graph._bilinear(g, x, 10, 12),
            _nchw(lambda x: F.interpolate(x, size=(10, 12), mode="bilinear",
                                          align_corners=False)),
            "FULLY_CONNECTED"),
    }


@pytest.mark.parametrize("case", list(_primitive_cases()))
def test_new_primitives_match_torch(tf, tmp_path, case):
    """Each primitive the new rows added (the -inf ``PadV2`` before a
    strided VALID pool, a zero pad before a stride-1 pool, a grouped conv,
    a depthwise conv with multiplier 2, a (1, 3) conv at strides (1, 2),
    exp/log in softplus, reverse, space to depth and back, the separable
    bilinear resize) written, converted and run by TensorFlow, TFLite and
    ``tf_np`` against torch."""
    shape, build, ref_fn, builtin = _primitive_cases()[case]
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(6))
    graph = _prim_graph(shape, build)
    sm = tf_proto.write_savedmodel(str(tmp_path / "sm"), graph)
    lite = export.export_tflite(sm, str(tmp_path / "p.tflite"))
    assert builtin in {tflite_fb.BUILTIN_NAMES[c]
                       for c in tflite_fb.load(lite).opcodes}
    with torch.no_grad():
        ref = ref_fn(x).numpy()
    feeds = {"rgb": x.numpy()}
    for got in (tf.saved_model.load(sm).serve(x.numpy()).numpy(),
                tflite_run(tf, lite, feeds)["output_0"],
                tf_np.run(tf_proto.load(sm), feeds)["output_0"],
                tf_np.run(tflite_fb.load(lite), feeds)["output_0"]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_tf_export_refuses(folded_cases, tmp_path):
    """``ValueError``: ``native=True`` in both entry points, a quantized
    (s8-storage) module, and a single-stream export of a two-stream
    model."""
    from mmidet_tpu_torch.nn.quant import make_quant_deploy
    model = folded_cases["add"][4]
    with pytest.raises(ValueError, match="native=True"):
        export.export_savedmodel(str(tmp_path / "n"), model, IMG,
                                 native=True)
    with pytest.raises(ValueError, match="native=True"):
        export.export_tflite(str(tmp_path / "n"), str(tmp_path / "n.tflite"),
                             native=True)
    rgb, ir = (torch.from_numpy(a) for a in _images())
    quant = make_quant_deploy(model, [(rgb, ir)])
    with pytest.raises(ValueError, match="quantized"):
        export.export_savedmodel(str(tmp_path / "q"), quant, IMG)
    with pytest.raises(ValueError, match="two-stream"):
        export.export_savedmodel(str(tmp_path / "s"), model, IMG,
                                 two_stream=False)
    assert not os.path.exists(tmp_path / "q")


def test_tf_codecs_round_trip():
    """The tensor bundle of ``variables/`` to the byte against what
    TensorFlow writes for the same object graph (the JAX package's
    SavedModel's, as TF 2.x lays it); CRC-32C's check value; the
    flatbuffer codec's encode -> decode of every options table."""
    og = bytes.fromhex(
        "0a1d0a090801120573657276650a0e0802120a7369676e6174757265732a000a0f"
        "0a0b0803120774726163655f302a000a170a130804120f73657276696e675f6465"
        "6661756c742a000a022a000a022a00")
    index, data = tf_proto.bundle(og)
    assert data.hex() == "51989acec1" + og.hex()
    assert index.hex() == (
        "00000608011a020801001c0b5f434845434b504f494e5441424c455f4f424a4543"
        "545f4752415048080712002856359788579f00000000010000000002092b290000"
        "00000100000000c0f2a1b000010260003b00000000010000000044f6c14940084d"
        "0e" + "00" * 36 + "57fb808b247547db")
    assert tf_proto.crc32c(b"123456789") == 0xE3069283
    ops = [tflite_fb.Operator(0, [0, -1], [1], name, {
        f: ([2, 3] if fmt == "[i" else 0.5 if fmt == "f" else True
            if fmt == "?" else 3) for f, _, fmt in fields})
        for name, (_, fields) in tflite_fb.OPTIONS.items()]
    m = tflite_fb.Model([tflite_fb.GELU], [
        tflite_fb.Tensor((2, 3), tflite_fb.FLOAT32, 1, "x"),
        tflite_fb.Tensor((), tflite_fb.INT32, 0, "y")], [0], [1], ops,
        [b"", np.arange(6, dtype=np.float32).tobytes()], {"x": 0}, {"y": 1})
    back = tflite_fb.decode(tflite_fb.encode(m))
    assert back == m
    np.testing.assert_array_equal(back.array(0), np.arange(6).reshape(2, 3))
