"""The port's evaluation inputs against the JAX package's: the synthetic
dataset writer, file discovery, labels and their cache, the loaders (each
decode leg against the same leg), ``collate_paired``, and the model specs
by name and from YAML.  Everything here is numpy or shapes: the gate is
exact equality."""

import dataclasses
import os

import numpy as np
import pytest

from mmidet_tpu.data import datasets as jds
from mmidet_tpu.data import loader as jloader
from mmidet_tpu.data import native as jnative
from mmidet_tpu.data.synthetic import make_synthetic_pair_dataset as jmake
from mmidet_tpu.models import spec as jspec
from mmidet_tpu.models import zoo as jzoo
from mmidet_tpu_torch.data import datasets as pds
from mmidet_tpu_torch.data import loader as ploader
from mmidet_tpu_torch.data import native as pnative
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.models import spec as pspec
from mmidet_tpu_torch.models import zoo as pzoo

# every name the JAX package's _named accepts
NAMES = ["yolov5s", "yolov5m6", "yolov5s_fuse3", "yolov5l_fuse3_fourier",
         "yolov5m_fourier", "yolov5s_gpt4", "yolov5s_transformer",
         "yolov5x_gpt3", "yolov5s_transformerx3", "yolov5m_add",
         "yolov5s_gpt1", "yolov5t_add", "yolov5s_mamba", "yolov5x_mamba"]


@pytest.fixture(scope="module")
def square(tmp_path_factory):
    root = tmp_path_factory.mktemp("square")
    yml = make_synthetic_pair_dataset(str(root), n=5, img=96)
    return pds.load_data_yaml(yml)


@pytest.fixture(scope="module")
def rect(tmp_path_factory):
    """Five pairs of mixed aspect (landscape, portrait, square), PNG and
    JPEG, with labels; one label file holds a segment row and a blank
    line."""
    from PIL import Image
    root = tmp_path_factory.mktemp("rect")
    rng = np.random.default_rng(3)
    for mod in ("rgb", "ir"):
        os.makedirs(root / mod / "images")
        os.makedirs(root / mod / "labels")
    for i, (w, h, ext) in enumerate([(120, 80, "png"), (80, 120, "jpg"),
                                     (96, 96, "png"), (130, 70, "jpg"),
                                     (100, 90, "png")]):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        for mod, arr in (("rgb", img), ("ir", 255 - img)):
            Image.fromarray(arr).save(root / mod / "images" / f"p{i}.{ext}")
        rows = ["%d %.5f %.5f %.5f %.5f" % (i % 2, *rng.uniform(0.2, 0.4, 4))
                for _ in range(i + 1)]
        if i == 2:
            rows += ["", "1 0.1 0.1 0.3 0.1 0.3 0.4 0.1 0.4"]
        (root / "rgb" / "labels" / f"p{i}.txt").write_text("\n".join(rows))
    return str(root / "rgb" / "images"), str(root / "ir" / "images")


def test_synthetic_dataset_writes_the_same_bytes(tmp_path):
    a = make_synthetic_pair_dataset(str(tmp_path / "a"), n=3, img=64, seed=5)
    b = jmake(str(tmp_path / "b"), n=3, img=64, seed=5)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "a")
                   for d, _, fs in os.walk(tmp_path / "a") for f in fs)
    assert len(files) == 13  # 3 x (2 images + 2 labels) + the yaml
    for f in files:
        got, want = (tmp_path / "a" / f).read_bytes(), (
            tmp_path / "b" / f).read_bytes()
        if f.endswith(".yaml"):
            got, want = got.replace(b"/a/", b"/"), want.replace(b"/b/", b"/")
        assert got == want, f
    assert pds.load_data_yaml(a)["nc"] == jds.load_data_yaml(b)["nc"] == 2


def test_discovery_labels_and_cache_match(rect, tmp_path):
    rgb, ir = rect
    files = pds.discover_images(rgb)
    assert files == jds.discover_images(rgb) and len(files) == 5
    list_file = tmp_path / "list.txt"
    list_file.write_text("\n".join(os.path.relpath(f, tmp_path)
                                   for f in files[:3]) + "\n")
    assert pds.discover_images(str(list_file)) == jds.discover_images(
        str(list_file))
    with pytest.raises(FileNotFoundError):
        pds.discover_images(str(tmp_path / "missing"))
    for f in files:
        assert pds.img2label_path(f) == jds.img2label_path(f)
        np.testing.assert_array_equal(
            pds.load_labels(pds.img2label_path(f), nc=2),
            jds.load_labels(jds.img2label_path(f), nc=2))
    assert pds._cache_key(files) == jds._cache_key(files)
    for tok in ("RGBimages", "IRimages", "images"):
        p = os.path.join("/d", tok, "x.jpg")
        assert pds.img2label_path(p) == jds.img2label_path(p)
    got = pds.load_labels_cached(files, str(tmp_path / "p.npz"), nc=2)
    want = jds.load_labels_cached(files, str(tmp_path / "j.npz"), nc=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # each package reads the other's cache file
    again = jds.load_labels_cached(files, str(tmp_path / "p.npz"), nc=2)
    assert all(np.array_equal(g, w) for g, w in zip(again, want))


def test_paired_dataset_matches(rect, tmp_path):
    rgb, ir = rect
    p = pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path / "p"))
    j = jds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path / "j"))
    assert len(p) == len(j) == 5
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))  # the same cache file name
    for i in range(5):
        a, b = p[i], j[i]
        assert set(a) == set(b)
        for k in ("rgb", "ir", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["shape"] == b["shape"] and a["rgb_file"] == b["rgb_file"]
    single = pds.SingleStreamDataset(rgb, nc=2, cache_dir=str(tmp_path))
    assert single.rgb_files == single.ir_files == p.rgb_files


def test_data_yaml_two_and_single_stream(square, tmp_path):
    import yaml
    one = tmp_path / "one.yaml"
    one.write_text(yaml.safe_dump({"train": square["train_rgb"], "nc": 2}))
    assert pds.load_data_yaml(str(one)) == jds.load_data_yaml(str(one))
    assert pds.load_data_yaml(str(one))["single_stream"]
    bad = tmp_path / "bad.yaml"
    bad.write_text(yaml.safe_dump({"train_rgb": "x", "nc": 2}))
    with pytest.raises(KeyError, match="missing"):
        pds.load_data_yaml(str(bad))


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("rgb", "ir", "targets", "mask"):
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["files"] == w["files"]
        assert len(g["shapes"]) == len(w["shapes"])
        for (s0, (r, pad)), (t0, (q, qad)) in zip(g["shapes"], w["shapes"]):
            assert tuple(s0) == tuple(t0) and r == q and tuple(pad) == tuple(
                qad)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("scaleup", [True, False])
def test_paired_loader_matches_each_leg(rect, tmp_path, use_native, scaleup):
    if use_native and not (pnative.available() and jnative.available()):
        pytest.skip("the native fastloader cannot be built here")
    rgb, ir = rect
    ds = pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path))
    kw = dict(img_size=64, max_labels=4, drop_last=False,
              use_native=use_native, scaleup=scaleup)
    loader = ploader.PairedLoader(ds, 2, **kw)
    assert loader.use_native is use_native
    _same_batches(list(loader), list(jloader.PairedLoader(ds, 2, **kw)))
    assert len(loader) == 3


def test_paired_loader_default_leg_and_shuffle(rect, tmp_path):
    rgb, ir = rect
    ds = pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path))
    loader = ploader.PairedLoader(ds, 2, 64, shuffle=True, seed=4,
                                  use_native=False)
    want = jloader.PairedLoader(ds, 2, 64, shuffle=True, seed=4,
                                use_native=False)
    for _ in range(2):  # the epoch advances the shuffle on both sides
        _same_batches(list(loader), list(want))
    assert ploader.PairedLoader(ds, 2).use_native == pnative.available()
    ds.cache_images = True
    assert ploader.PairedLoader(ds, 2).use_native is False


def test_loader_raises_what_its_thread_raised(rect, tmp_path):
    rgb, ir = rect
    ds = pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path))
    ds.rgb_files = ds.rgb_files[:2] + ["/nonexistent.png"] * 3
    with pytest.raises(FileNotFoundError):
        list(ploader.PairedLoader(ds, 2, 64, use_native=False))


def test_rect_loader_shapes_order_and_batches(rect, tmp_path):
    rgb, ir = rect
    ds = pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path))
    got = ploader.RectLoader(ds, 2, img_size=64, max_labels=3)
    want = jloader.RectLoader(ds, 2, img_size=64, max_labels=3)
    assert got.shapes == want.shapes
    np.testing.assert_array_equal(got.order, want.order)
    assert len({s for s in got.shapes}) > 1
    assert any(h != w for h, w in got.shapes)
    assert got.use_native is False
    _same_batches(list(got), list(want))


def test_collate_paired_padding_and_mask(rect, tmp_path):
    rgb, ir = rect
    ds = pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path))
    samples = [ds[i] for i in range(5)]
    for kw in (dict(max_labels=2), dict(max_labels=8, shape_hw=(64, 96)),
               dict(max_labels=8, shape_hw=(96, 64), scaleup=False)):
        got = ploader.collate_paired(samples, 64, **kw)
        _same_batches([got], [jloader.collate_paired(samples, 64, **kw)])
        n = [min(len(s["labels"]), kw["max_labels"]) for s in samples]
        assert got["mask"].sum(1).tolist() == n
        assert not got["targets"][~got["mask"]].any()


def _fields(spec):
    return dataclasses.astuple(spec)


@pytest.mark.parametrize("name", NAMES)
def test_named_specs_match(name):
    assert _fields(pzoo.get_model_spec(name)) == _fields(
        jzoo.get_model_spec(name))
    anchors = [[1, 2, 3, 4, 5, 6]] * 3
    assert _fields(pzoo.get_model_spec(name, nc=3, anchors=anchors)) == \
        _fields(jzoo.get_model_spec(name, nc=3, anchors=anchors))


def test_mamba_is_refused():
    """No longer refused: the mamba family builds, the JAX package's spec
    (the gpt4 grammar with MambaFusion at its four fusion rows)."""
    spec = pzoo.get_model_spec("yolov5s_mamba")
    assert _fields(spec) == _fields(jzoo.get_model_spec("yolov5s_mamba"))
    gpt4 = pzoo.get_model_spec("yolov5s_gpt4")
    assert [l.name for l in spec.layers] == [
        "MambaFusion" if l.name == "GPT" else l.name for l in gpt4.layers]


def _yaml_dict():
    """tests/test_model.py's two-stream YAML, plus a nearest Upsample."""
    return {
        "nc": 2, "depth_multiple": 0.33, "width_multiple": 0.25,
        "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]],
        "backbone": [[-1, 1, "Focus", [64, 3]], [-1, 1, "Conv", [128, 3, 2]],
                     [-1, 3, "C3", [128]], [-4, 1, "Focus", [64, 3]],
                     [-1, 1, "Conv", [128, 3, 2]], [-1, 3, "C3", [128]],
                     [[2, 5], 1, "Add", [1]], [-1, 1, "Conv", [256, 3, 2]],
                     [-1, 1, "Conv", [512, 3, 2]]],
        "head": [[-1, 1, "Conv", [512, 1, 1]],
                 [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
                 [[-1, 7], 1, "Concat", [1]],
                 [-1, 1, "Conv", [256, 3, 2]],
                 [[7, 8, 12], 1, "Detect", ["nc", "anchors"]]],
    }


def test_yaml_spec_matches(tmp_path):
    import yaml
    path = tmp_path / "m.yaml"
    path.write_text(yaml.safe_dump(_yaml_dict()))
    for src in (_yaml_dict(), str(path)):
        got, want = pspec.load_yolo_yaml(src), jspec.load_yolo_yaml(src)
        assert _fields(got) == _fields(want)
    assert got.strides == (8, 16, 16)
    assert _fields(pspec.load_yolo_yaml(str(path), nc=5)) == _fields(
        jspec.load_yolo_yaml(str(path), nc=5))
    bad = _yaml_dict()
    bad["head"][0][3] = ["width"]
    with pytest.raises(ValueError, match="non-literal"):
        pspec.load_yolo_yaml(bad)


@pytest.mark.parametrize("make", [
    lambda z: z.single_stream_p6_spec("s", nc=4),
    lambda z: z.dryrun_spec(),
])
def test_infer_strides_matches(make):
    """From the provisional strides (8, 16, 32[, 64]) of a spec; the P6
    spec's four levels and a two-stream one; on the meta device, so no
    full-width weights are made."""
    p = dataclasses.replace(make(pzoo), strides=(1,) * len(make(pzoo).anchors))
    j = dataclasses.replace(make(jzoo), strides=(1,) * len(make(jzoo).anchors))
    got, want = pspec._infer_strides(p), jspec._infer_strides(j)
    assert got.strides == want.strides == make(pzoo).strides
    assert _fields(got) == _fields(want)
