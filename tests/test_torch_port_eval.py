"""The port's evaluator, TTA and metrics against the JAX package's, on the
CPU in f32: a tiny two-stream model (``dryrun_spec``) and a tiny
single-stream one, weights bridged from the same JAX variables, the same
collated batches on both sides.  The labels are the port's own top
detections, jittered and some dropped, so that P, R and every mAP lie
strictly between 0 and 1 and a difference in the detections shows.

Gates: mAP@.5, mAP@.75 and mAP@.5:.95 within 1e-6 absolute (the two sides
differ in the order of f32 sums only, which moves scores by about 1e-7 and
leaves the ranking and every match as they are); P and R within 1e-5: they
are read off the precision and recall curves interpolated in the score at
the F1 peak, so a score moved by 1e-7 between two detections 1e-4 apart
with a precision step of 0.05 between them moves them by 5e-5 x 1e-1;
boxes and scores
in the ``save_json`` and ``save_txt`` files within 1e-4 (pixel boxes
within 1e-4 relative besides), in any order among equal scores."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mmidet_tpu.eval import evaluator as jev
from mmidet_tpu.eval import metrics as jm
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.tta import scale_img as jax_scale_img
from mmidet_tpu.models.zoo import dryrun_spec as jax_dryrun
from mmidet_tpu.models.zoo import single_stream_spec as jax_single
from mmidet_tpu.models.zoo import two_stream_spec as jax_two
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.data.datasets import PairedDataset, load_data_yaml
from mmidet_tpu_torch.data.loader import PairedLoader, RectLoader
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.eval import evaluator as pev
from mmidet_tpu_torch.eval import metrics as pm
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.tta import scale_img
from mmidet_tpu_torch.models.zoo import (dryrun_spec, single_stream_spec,
                                         two_stream_spec)

METRIC_TOL = 1e-6  # mAPs
PR_TOL = 1e-5  # P, R (see above)
FILE_TOL = 1e-4
F32_TOL = dict(rtol=1e-4, atol=1e-4)  # forward: f32, sum order only



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tiny models gain nothing from more intra-op threads; fewer keep this
    file from crowding the test workers that share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

def _variables(jmodel, two_stream, seed):
    """Seeded variables of the shapes ``jmodel.init`` makes (traced only,
    so nothing is compiled): kernels N(0, 1/fan_in), so that activations
    keep their scale and the detections' scores depend on the image and
    spread apart; BN variances U(0.5, 1.5); scales 1 + N(0, 0.1); every
    other leaf N(0, 0.1)."""
    z = jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(
        lambda k, a, b: jmodel.init({"params": k}, a, b if two_stream
                                    else None, train=False),
        jax.ShapeDtypeStruct((2,), np.uint32), z, z)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("kernel", "conv_kernel_s2d"):
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("scale", "sobel_factor"):
            v = 1 + rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _pair(jax_spec, port_spec, use_cem=True, seed=0):
    """The JAX model, its variables, and the port's model with the same
    weights (bridged); the single-stream models here take no IR input."""
    jmodel = JaxDetector(spec=jax_spec, use_cem=use_cem, aux_mode="off")
    v = _variables(jmodel, use_cem, seed)
    pmodel = TwoStreamDetector(port_spec, use_cem=use_cem)
    from_jax_variables(pmodel, v)
    return jmodel, v, pmodel.eval()


@pytest.fixture(scope="module")
def two_stream():
    return _pair(jax_dryrun(nc=2, fusion_layers=1),
                 dryrun_spec(nc=2, fusion_layers=1))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    d = load_data_yaml(make_synthetic_pair_dataset(str(root), n=4, img=96))
    return PairedDataset(d["val_rgb"], d["val_ir"], nc=2,
                         cache_dir=str(root))


def _pseudo_labelled(batches, pmodel, two_stream=True, keep=12):
    """The batches with labels made from the port's detections: every
    other one of the first ``2 * keep``, its box jittered by N(0, 1.5 px),
    every third one's class flipped; padded frame, normalized xywh."""
    rng = np.random.default_rng(1)
    out = []
    for b in batches:
        rgb = torch.from_numpy(b["rgb"]).float() / 255.0
        ir = torch.from_numpy(b["ir"]).float() / 255.0
        with torch.inference_mode():
            dets, valid = pev.infer_batch(pmodel, rgb,
                                          ir if two_stream else None,
                                          0.001, 0.6)
        ih, iw = rgb.shape[1:3]
        targets = np.zeros((len(dets), keep, 5), np.float32)
        mask = np.zeros((len(dets), keep), bool)
        for i, (d, v) in enumerate(zip(dets.numpy(), valid.numpy())):
            d = d[v][:2 * keep:2]
            d[:, :4] += rng.normal(0, 1.5, d[:, :4].shape)
            cls = d[:, 5].copy()
            cls[::3] = 1 - cls[::3]
            n = len(d)
            targets[i, :n, 0] = cls
            targets[i, :n, 1] = (d[:, 0] + d[:, 2]) / 2 / iw
            targets[i, :n, 2] = (d[:, 1] + d[:, 3]) / 2 / ih
            targets[i, :n, 3] = (d[:, 2] - d[:, 0]) / iw
            targets[i, :n, 4] = (d[:, 3] - d[:, 1]) / ih
            mask[i, :n] = True
        out.append({**b, "targets": targets, "mask": mask})
    return out


@pytest.fixture(scope="module")
def batches(dataset, two_stream):
    plain = list(PairedLoader(dataset, 2, img_size=64, drop_last=False,
                              use_native=False, scaleup=False))
    return _pseudo_labelled(plain, two_stream[2])


def _metrics(r):
    return np.asarray([r.mp, r.mr, r.map50, r.map75, r.map])


def _run_both(models, batches, tmp_path, two_stream=True, **kw):
    jmodel, v, pmodel = models
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        files = dict(save_json=str(d / "det.json"),
                     save_txt_dir=str(d / "labels"),
                     confusion_dir=str(d / "cm"))
        os.makedirs(d)
        if side == "jax":
            res = jev.evaluate(jmodel, v, batches, nc=2, shard=False,
                               two_stream=two_stream, **files, **kw)
        else:
            res = pev.evaluate(pmodel, batches, nc=2, device="cpu",
                               two_stream=two_stream, **files, **kw)
        out[side] = (res, d)
    return out


def _same_rows(a, b, rtol=0.0):
    """The same rows up to order (equal scores may come in either order:
    ``torch.topk`` and ``jax.lax.top_k`` order ties differently), each
    value within ``FILE_TOL`` absolute plus ``rtol`` relative (pixel
    boxes: f32 sums in another order move a 60 px coordinate by about
    1e-4)."""
    assert sorted(len(r) for r in a) == sorted(len(r) for r in b) and a
    for n in {len(r) for r in a}:  # save_hybrid's label rows are shorter
        rows = np.asarray([r for r in a if len(r) == n])
        other = np.asarray([r for r in b if len(r) == n])
        used = np.zeros(len(other), bool)
        for row in rows:
            close = np.abs(other - row) <= FILE_TOL + rtol * np.abs(row)
            cand = np.nonzero(close.all(1) & ~used)[0]
            assert cand.size, f"no counterpart for {row}"
            used[cand[0]] = True


def _check_same(out):
    (jres, jd), (pres, pd) = out["jax"], out["port"]
    m = _metrics(pres)
    assert ((m > 0) & (m < 1)).all(), m  # not degenerate
    np.testing.assert_allclose(m[:2], _metrics(jres)[:2], rtol=0,
                               atol=PR_TOL)
    np.testing.assert_allclose(m[2:], _metrics(jres)[2:], rtol=0,
                               atol=METRIC_TOL)
    assert set(pres.per_class) == set(jres.per_class)
    recs = [json.load(open(d / "det.json")) for d in (pd, jd)]
    assert len(recs[0]) == len(recs[1]) > 0
    for image in {r["image_id"] for r in recs[0]}:
        a, b = ([[r["category_id"], r["score"], *r["bbox"]] for r in rs
                 if r["image_id"] == image] for rs in recs)
        _same_rows(a, b, rtol=FILE_TOL)
    names = sorted(os.listdir(pd / "labels"))
    assert names == sorted(os.listdir(jd / "labels")) and len(names) == 4
    for n in names:
        a, b = ([[float(x) for x in ln.split()] for ln in
                 (d / "labels" / n).read_text().splitlines()]
                for d in (pd, jd))
        _same_rows(a, b)
    np.testing.assert_array_equal(np.loadtxt(pd / "cm" /
                                             "confusion_matrix.txt"),
                                  np.loadtxt(jd / "cm" /
                                             "confusion_matrix.txt"))


def test_evaluate_matches_jax(two_stream, batches, tmp_path):
    out = _run_both(two_stream, batches, tmp_path, save_conf=True,
                    save_hybrid=True)
    _check_same(out)
    assert out["port"][0].speed_ms[0] > 0


@pytest.mark.parametrize("kw", [{"augment": True}, {"merge": True}],
                         ids=["augment", "merge"])
def test_evaluate_tta_and_merge_match_jax(two_stream, batches, tmp_path, kw):
    _check_same(_run_both(two_stream, batches, tmp_path, **kw))


def test_single_stream_route_matches_jax(dataset, tmp_path):
    """``use_cem=False``, no IR input: a single-stream spec evaluated with
    ``two_stream=False`` on both sides."""
    models = _pair(jax_single("t", nc=2), single_stream_spec("t", nc=2),
                   use_cem=False, seed=2)
    assert not hasattr(models[2], "Enhance")
    plain = list(PairedLoader(dataset, 2, img_size=64, drop_last=False,
                              use_native=False, scaleup=False))
    labelled = _pseudo_labelled(plain, models[2], two_stream=False)
    _check_same(_run_both(models, labelled, tmp_path, two_stream=False))


def test_rect_batches_through_the_evaluator(two_stream, dataset, tmp_path):
    """RectLoader's batches (non-square for a non-square set) give the
    JAX package's results too."""
    from PIL import Image
    root = tmp_path / "rect"
    for mod in ("rgb", "ir"):
        os.makedirs(root / mod)
    for i in range(4):
        for mod, f in (("rgb", dataset.rgb_files[i]),
                       ("ir", dataset.ir_files[i])):
            im = Image.open(f)
            im.crop((0, 0, 96, 72 if i % 2 else 60)).save(
                root / mod / f"r{i}.png")
    ds = PairedDataset(str(root / "rgb"), str(root / "ir"), nc=2,
                       cache_dir=str(root))
    loader = RectLoader(ds, 2, img_size=64)
    assert all(h < w for h, w in loader.shapes), loader.shapes
    labelled = _pseudo_labelled(list(loader), two_stream[2])
    _check_same(_run_both(two_stream, labelled, tmp_path))


def test_scale_img_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    for ratio in (1.0, 0.83, 0.67):
        want = np.asarray(jax_scale_img(x, ratio, gs=16))
        got = scale_img(torch.from_numpy(x), ratio, gs=16).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fusion", ["gpt3", "add"])
def test_gpt3_and_add_grammars_match_jax(fusion):
    jmodel, v, pmodel = _pair(jax_two("t", fusion, nc=2, fusion_layers=1),
                              two_stream_spec("t", fusion, nc=2,
                                              fusion_layers=1))
    rng = np.random.default_rng(4)
    rgb, ir = (rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
               for _ in range(2))
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        v, rgb, ir)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(rgb), torch.from_numpy(ir))
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               **F32_TOL)
    for g, w in zip(got["train_outs"], want["train_outs"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    n, m = 200, 40
    tp = rng.uniform(0, 1, (n, 10)) < np.linspace(0.8, 0.2, 10)
    conf = rng.uniform(0, 1, n)
    pred_cls = rng.integers(0, 3, n).astype(float)
    target_cls = rng.integers(0, 4, m).astype(float)
    for g, w in zip(pm.ap_per_class(tp, conf, pred_cls, target_cls),
                    jm.ap_per_class(tp, conf, pred_cls, target_cls)):
        np.testing.assert_array_equal(g, w)
    rec, prec = np.sort(rng.uniform(0, 1, 30)), rng.uniform(0, 1, 30)
    for g, w in zip(pm.compute_ap(rec, prec), jm.compute_ap(rec, prec)):
        np.testing.assert_array_equal(g, w)
    m4 = rng.uniform(0, 1, (5, 7))
    np.testing.assert_array_equal(pm.fitness(m4), jm.fitness(m4))
    xy = rng.uniform(0, 50, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1)
    pred = np.concatenate([boxes, conf[:, None], pred_cls[:, None]], 1)
    labels = np.concatenate([target_cls[:, None], boxes[:m] + rng.normal(
        0, 3, (m, 4))], 1)
    np.testing.assert_array_equal(pm.box_iou_np(boxes, boxes[:m]),
                                  jm.box_iou_np(boxes, boxes[:m]))
    iouv = np.linspace(0.5, 0.95, 10)
    got = pm.match_predictions(pred, labels, iouv)
    assert got.any()
    np.testing.assert_array_equal(got, jm.match_predictions(pred, labels,
                                                            iouv))
    a, b = pm.ConfusionMatrix(4), jm.ConfusionMatrix(4)
    for cm in (a, b):
        cm.process_batch(pred, labels)
    np.testing.assert_array_equal(a.matrix, b.matrix)
    assert a.matrix.sum() > 0
    assert pm.coco80_to_coco91_class() == jm.coco80_to_coco91_class()


def test_evaluate_defaults_to_the_card(two_stream, batches):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pev.evaluate(two_stream[2], batches, nc=2)
