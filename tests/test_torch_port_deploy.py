"""The port's deploy bundles (``deploy/export.py``), hub (``hub.py``) and
ensembles (``models/ensemble.py``) on the CPU, against the JAX package's.

Gates: ``model.json`` equal to the JAX writer's for the same spec, and the
spec each package rebuilds from it the same; a bundle round trip gives the
same tensors and the same predictions; ``AutoShapeModel`` (single-stream,
two-stream with the CEM and GPT, with and without TTA) gives JAX's records on the
same images and weights: the same count, classes and order, boxes within
1e-3 px and confidences within 1e-4 relative (f32 on both sides, sums in
another order; the weights are conditioned, ``_conditioned``, so that
scores follow the image and NMS does not choose among equal scores); ``Ensemble`` JAX's predictions within 1e-4; a bundle dir
loads through ``load_state_dict_file``, ``serve --weights``, ``hub.custom``,
``attempt_load_ensemble`` and the trainer's ``--weights``."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from mmidet_tpu import hub as jax_hub
from mmidet_tpu.deploy import export as jax_export
from mmidet_tpu.models import ensemble as jax_ensemble
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.models.zoo import two_stream_spec as jax_two
from mmidet_tpu_torch import hub
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.cli import val
from mmidet_tpu_torch.deploy import export, serve
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.ensemble import Ensemble, attempt_load_ensemble
from mmidet_tpu_torch.models.zoo import get_model_spec, two_stream_spec
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.nn.layers import ConvBnAct

from test_torch_port_export import _images as _export_images
from test_torch_port_export import check_tf_bundle, tf  # noqa: F401
from test_torch_port_quant import _jax_variables
from test_torch_port_serve import _same

F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tiny models gain nothing from more intra-op threads; fewer keep this
    file from crowding the test workers that share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@torch.no_grad()
def _conditioned(model, rgb, ir):
    """Layer-sequential unit variance (LSUV, as ``chip_smoke.py``'s
    ``condition``) on the unfused model: every BatchNorm of the backbones
    and the neck scaled so that its output has unit spread on these
    images.  A seeded init lets activations fade, so that every score sits
    near the Detect prior, boxes of the same score pile up and NMS keeps one
    or the other by rounding noise; conditioned, scores follow the
    image."""
    def unit(mod, inp, out):
        s = float(out.std())
        mod.weight.div_(s)
        mod.bias.div_(s)
        return out / s
    hooks = [m.register_forward_hook(unit) for n, m in model.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)
             and not n.startswith("Enhance")]
    model.eval()(rgb, ir)
    for h in hooks:
        h.remove()
    return model


def _pair(jax_spec, port_spec, seed: int, use_cem: bool = True):
    """JAX's model and the port's deploy form (BN folded) on the same
    conditioned weights (the port's seeded init through JAX's converter)."""
    jmodel = JaxDetector(spec=jax_spec, use_cem=use_cem, aux_mode="off")
    torch.manual_seed(seed)
    model = TwoStreamDetector(port_spec, use_cem=use_cem)
    two = any(ld.f == -4 for ld in port_spec.layers)
    x = torch.rand(2, 64, 64, 6, generator=torch.Generator().manual_seed(seed))
    _conditioned(model, x[..., :3], x[..., 3:] if two else None)
    sd = model.state_dict()
    v = _jax_variables(jmodel, sd) if two else _single_variables(jmodel, sd)
    return jmodel, v, fold_batchnorm(model.eval())


def _single_variables(jmodel, sd):
    from mmidet_tpu.train.checkpoint import convert_torch_state_dict
    z = jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda k, a: jmodel.init({"params": k}, a, train=False),
            jax.ShapeDtypeStruct((2,), np.uint32), z))
    return convert_torch_state_dict(dict(template), sd, strict=True)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Four images of different shapes: a file, a PIL image, an HWC and a
    CHW array."""
    from PIL import Image
    rng = np.random.default_rng(5)
    arrs = [rng.integers(0, 255, s, np.uint8)
            for s in ((48, 64, 3), (64, 40, 3), (56, 56, 3), (40, 72, 3))]
    path = str(tmp_path_factory.mktemp("img") / "a.png")
    Image.fromarray(arrs[0]).save(path)
    inputs = [path, Image.fromarray(arrs[1]), arrs[2],
              arrs[3].transpose(2, 0, 1)]
    return inputs, arrs


def _records_match(got, want):
    assert got.n == want.n
    for g, w in zip(got.pandas(), want.pandas()):
        _same(g, w)


@pytest.fixture(scope="module")
def single():
    """The tiny single-stream model (no CEM)."""
    return _pair(jax_get_spec("yolov5t", nc=3),
                 get_model_spec("yolov5t", nc=3), 1, use_cem=False)


def test_autoshape_single_stream_matches_jax(images, single):
    jmodel, v, model = single
    names = ["x", "y", "z"]
    want = jax_hub.AutoShapeModel(jmodel, v, names, img_size=64,
                                  conf=1e-3)(images[0])
    m = hub.AutoShapeModel(model, names, img_size=64, conf=1e-3,
                           device="cpu")
    got = m(images[0])
    _records_match(got, want)
    assert sum(len(r) for r in got.pandas()) > 4
    # one image in, one record list out; conf is read at each call
    m.conf = 0.5
    assert m(images[1][2]).n == 1 and m(images[1][2]).pandas() == [[]]


@pytest.fixture(scope="module")
def two_stream():
    """The tiny two-stream model with the CEM and GPT (one layer)."""
    return _pair(jax_two("t", "gpt4", nc=2, fusion_layers=1),
                 two_stream_spec("t", "gpt4", nc=2, fusion_layers=1), 2)


@pytest.mark.parametrize("augment", [False, True])
def test_autoshape_two_stream_matches_jax(images, two_stream, augment):
    jmodel, v, model = two_stream
    ir = [a[::-1].copy() for a in images[1]]
    want = jax_hub.AutoShapeModel(jmodel, v, ["a", "b"], img_size=64,
                                  conf=1e-3, two_stream=True,
                                  augment=augment)(images[0], ir)
    got = hub.AutoShapeModel(model, ["a", "b"], img_size=64, conf=1e-3,
                             two_stream=True, augment=augment,
                             device="cpu")(images[0], ir)
    _records_match(got, want)
    assert sum(len(r) for r in got.pandas()) > 4


def test_detections_helpers(images, two_stream, tmp_path, capsys):
    _, _, model = two_stream
    dets = hub.AutoShapeModel(model, ["a", "b"], img_size=64, conf=1e-3,
                              two_stream=True, device="cpu")(
        images[0], images[0])
    assert dets.n == 4 and repr(dets).startswith("Detections(4 images, ")
    recs = dets.pandas()
    n = sum(len(r) for r in recs)
    for img, r in zip(dets.imgs, recs):
        h, w = img.shape[:2]
        assert all(0 <= d["xmin"] <= d["xmax"] <= w
                   and 0 <= d["ymin"] <= d["ymax"] <= h for d in r)
    rendered = dets.render()
    assert [a.shape for a in rendered] == [a.shape for a in dets.imgs]
    assert any((a != b).any() for a, b in zip(rendered, dets.imgs))
    saved = dets.save(str(tmp_path / "hub"))
    assert [os.path.basename(p) for p in saved] == [
        f"image{i}.jpg" for i in range(4)]
    crops = dets.crop(str(tmp_path / "crops"))
    assert len(crops) == n and all(c.ndim == 3 for c in crops)
    assert sorted(os.listdir(tmp_path / "crops")) == sorted(
        {d["name"] for r in recs for d in r})
    parts = dets.tolist()
    assert [p.pandas() for p in parts] == [[r] for r in recs]
    dets.print()
    assert "Detections(4 images" in capsys.readouterr().out


def test_autoshape_and_hub_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hub.AutoShapeModel(torch.nn.Identity(), ["a"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hub.yolov5s_gpt4()


def test_hub_constructors_are_seeded():
    a = hub.mmidet(nc=2, scale="t", fusion="add", img_size=64,
                   device="cpu")
    b = hub._make("yolov5t_add", 2, img_size=64, device="cpu")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.two_stream and not a.model.model[0].conv.bn
    single = hub._make("yolov5t", 3, device="cpu")
    assert not single.two_stream and not single.model.use_cem
    for name in ("yolov5s", "yolov5m", "yolov5l", "yolov5x", "yolov5s6",
                 "yolov5m6", "yolov5l6", "yolov5x6", "yolov5s_gpt4",
                 "mmidet", "custom"):
        assert callable(getattr(hub, name))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny two-stream model's unfused weights as a deploy bundle."""
    spec = get_model_spec("yolov5t_add", nc=2)
    torch.manual_seed(2)
    model = TwoStreamDetector(spec)
    path = str(tmp_path_factory.mktemp("bundle") / "b")
    export.export_deploy_bundle(path, model, spec, names=["p", "q"],
                                img_size=64)
    return path, spec, model


def test_bundle_round_trip_and_json_match_jax(bundle, tmp_path,
                                              monkeypatch):
    path, spec, model = bundle
    assert sorted(os.listdir(path)) == ["model.json", "model.pt",
                                        "model.pt2"]
    got_spec, sd, meta = export.load_deploy_bundle(path)
    assert got_spec == spec and meta["names"] == ["p", "q"]
    own = model.state_dict()
    assert list(sd) == list(own)
    assert all(torch.equal(sd[k], own[k]) for k in own)
    # the JAX writer, on the same spec (its StableHLO leg left out)
    jspec = jax_get_spec("yolov5t_add", nc=2)
    monkeypatch.setattr(jax_export, "export_stablehlo", _no_stablehlo)
    jax_dir = str(tmp_path / "jax")
    jmodel = JaxDetector(spec=jspec, aux_mode="off")
    jax_export.export_deploy_bundle(
        jax_dir, jmodel, _jax_variables(jmodel, own), jspec,
        names=["p", "q"], img_size=64)
    assert json.load(open(os.path.join(path, "model.json"))) == \
        json.load(open(os.path.join(jax_dir, "model.json")))
    jax_spec, jvars, _ = jax_export.load_deploy_bundle(jax_dir)
    assert dataclasses.asdict(jax_spec) == dataclasses.asdict(got_spec)
    # the JAX bundle's variables bridge back onto the same tensors
    back = TwoStreamDetector(got_spec)
    from_jax_variables(back, jax.tree_util.tree_map(np.asarray, jvars))
    assert all(torch.equal(back.state_dict()[k], own[k]) for k in own
               if not k.endswith("num_batches_tracked"))


def _no_stablehlo(*a, **kw):
    raise RuntimeError("not exported in this test")


def test_bundle_loads_everywhere(bundle, monkeypatch):
    path, spec, model = bundle
    sd = val.load_state_dict_file(path)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    ref = fold_batchnorm(TwoStreamDetector(spec))
    ref.load_state_dict(fold_batchnorm(model).state_dict())
    rgb = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = ref.eval()(rgb, rgb.flip(1))["pred"]
    # hub.custom: names and img_size from model.json
    custom = hub.custom(path, conf=1e-3, device="cpu")
    assert custom.names == ["p", "q"] and custom.img_size == 64
    with torch.no_grad():
        torch.testing.assert_close(custom.model(rgb, rgb.flip(1))["pred"],
                                   want, **F32_TOL)
    # the serve CLI's --weights
    chosen = []
    monkeypatch.setattr(serve, "serve", lambda svc, *a: chosen.append(svc))
    svc = serve.main(["--cfg", "yolov5t_add", "--nc", "2", "--weights",
                      path, "--img-size", "64", "--no-batching"],
                     device="cpu")
    assert chosen == [svc]
    # ensembles of bundles: each member's predictions, concatenated
    ens = attempt_load_ensemble([path, path], device="cpu")
    assert isinstance(ens, Ensemble) and len(ens.members) == 2
    with torch.no_grad():
        out = ens(rgb, rgb.flip(1))["pred"]
    torch.testing.assert_close(out, torch.cat([want, want], 1), **F32_TOL)
    # a quantized model's bundle rebuilds the quantized form
    from mmidet_tpu_torch.nn.quant import make_quant_deploy
    quant = make_quant_deploy(ref, [(rgb, rgb.flip(1))])
    qpath = path + "_int8"
    export.export_deploy_bundle(qpath, quant, spec, img_size=64)
    back = hub.custom(qpath, device="cpu").model
    assert all(m.quant for m in back.modules()
               if isinstance(m, ConvBnAct)) and all(
        torch.equal(back.state_dict()[k], v)
        for k, v in quant.state_dict().items())
    with torch.no_grad():
        torch.testing.assert_close(back(rgb, rgb.flip(1))["pred"],
                                   quant(rgb, rgb.flip(1))["pred"],
                                   rtol=0, atol=0)


def test_export_cli_writes_a_bundle(bundle, tmp_path, tf):
    """``python -m mmidet_tpu_torch.deploy.export``: the weights given
    come back through ``load_state_dict_file``; a blank ``--weights``
    writes the seeded init; ``--savedmodel --tflite`` add the JAX
    bundle's ``savedmodel/``, ``savedmodel_graph/`` and ``model.tflite``,
    which TensorFlow runs as the BN-folded model (the ONNX leg and the
    TF legs against JAX: ``test_torch_port_export.py``)."""
    path, spec, _ = bundle
    out = str(tmp_path / "cli")
    assert export.main(["--cfg", "yolov5t_add", "--nc", "2", "--weights",
                        path, "--names", "p", "q", "--img-size", "64",
                        "--out", out, "--savedmodel", "--tflite"],
                       device="cpu") == out
    sd = val.load_state_dict_file(out)
    own = val.load_state_dict_file(path)
    assert list(sd) == list(own)
    assert all(torch.equal(sd[k], own[k]) for k in own)
    got_spec, _, meta = export.load_deploy_bundle(out)
    assert got_spec == spec and meta["names"] == ["p", "q"]
    assert meta["img_size"] == 64
    seeded = str(tmp_path / "seeded")
    export.main(["--cfg", "yolov5t_add", "--nc", "2", "--out", seeded],
                device="cpu")
    init = val.build_model(spec).state_dict()
    assert all(torch.equal(v, init[k])
               for k, v in val.load_state_dict_file(seeded).items())
    rgb, ir = (torch.from_numpy(a[:1]) for a in _export_images())
    check_tf_bundle(tf, out,
                    fold_batchnorm(val.build_model(spec, own).eval()), rgb,
                    ir)


class _Stop(Exception):
    pass


def test_trainer_takes_a_bundle(bundle, tmp_path, monkeypatch):
    """``--weights <bundle>``: the trainer transfers every tensor of the
    bundle into its model (stopped right after)."""
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.train import trainer
    path, spec, model = bundle
    got, real = [], trainer.transfer_matching

    def transfer(m, loaded):
        got.append(real(m, loaded))
        raise _Stop
    monkeypatch.setattr(trainer, "transfer_matching", transfer)
    data = make_synthetic_pair_dataset(str(tmp_path / "d"), n=2, img=64)
    cfg = trainer.TrainConfig(model="yolov5t_add", data=data, weights=path,
                              epochs=1, batch_size=2, img_size=64,
                              mosaic_prob=0.0, dtype="float32",
                              workdir=str(tmp_path / "run"))
    with pytest.raises(_Stop):
        trainer.train(cfg, device="cpu")
    n_copied, n_total = got[0]
    assert n_copied == n_total > 100


def test_ensemble_matches_jax(single):
    jmodel, v, model = single
    jmodel2, v2, model2 = _pair(jax_get_spec("yolov5t", nc=3),
                                get_model_spec("yolov5t", nc=3), 3,
                                use_cem=False)
    rgb = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jens = jax_ensemble.Ensemble([(jmodel, v), (jmodel2, v2)])
    want = np.array(jax.jit(lambda a: jens(a)["pred"])(rgb))
    ens = Ensemble([model, model2])
    with torch.no_grad():
        out = ens(torch.from_numpy(rgb))
    assert out["pred"].shape == (2, 2 * 252, 8) and out["aux"] == {}
    # boxes in pixels: sums in another order move them by about 1e-6 of
    # the image's size
    torch.testing.assert_close(out["pred"], torch.from_numpy(want),
                               rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))
