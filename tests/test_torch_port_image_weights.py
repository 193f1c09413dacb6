"""``image_weights`` in the port against the JAX package on the CPU: both
loaders (``MosaicLoader``, ``PairedLoader``) under weights give JAX's
loaders' batches bit for bit for the same seed and epochs (PIL leg on both
sides), ``RectLoader`` takes none; then the port's trainer reweights each
next epoch by ``labels_to_image_weights`` of the class weights times
``(1 - maps) ** 2`` from the last evaluation and draws that epoch's images
by them, on a tiny model."""

import dataclasses

import numpy as np
import pytest
import torch

from mmidet_tpu.data import datasets as jds
from mmidet_tpu.data import loader as jloader
from mmidet_tpu_torch.data import datasets as pds
from mmidet_tpu_torch.data import loader as ploader
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.utils.general import (labels_to_class_weights,
                                            labels_to_image_weights)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("iw")
    yaml_path = make_synthetic_pair_dataset(str(root), n=6, img=48)
    d = pds.load_data_yaml(yaml_path)
    return (yaml_path,
            pds.PairedDataset(d["train_rgb"], d["train_ir"], nc=2,
                              cache_dir=str(root / "p")),
            jds.PairedDataset(d["train_rgb"], d["train_ir"], nc=2,
                              cache_dir=str(root / "j")))


def _same(got: dict, want: dict):
    for k in want:
        if k in ("shapes", "files"):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


WEIGHTS = np.array([5.0, 0.0, 1.0, 0.5, 3.0, 0.25])


@pytest.mark.parametrize("kind", ["mosaic", "paired"])
def test_loaders_under_weights_against_jax(data, kind):
    _, p, j = data
    if kind == "mosaic":
        got, want = (mod.MosaicLoader(ds, 2, 48, max_labels_tile=4, seed=3,
                                      prefetch=1, use_native=False)
                     for mod, ds in ((ploader, p), (jloader, j)))
    else:
        got, want = (mod.PairedLoader(ds, 2, 48, max_labels=6, shuffle=True,
                                      seed=3, prefetch=1, use_native=False)
                     for mod, ds in ((ploader, p), (jloader, j)))
    for g, w in zip(got, want, strict=True):  # epoch 0: the permutation
        _same(g, w)
    got.set_image_weights(WEIGHTS)
    want.set_image_weights(WEIGHTS)
    np.testing.assert_array_equal(got.image_weights, want.image_weights)
    for _ in range(2):  # epochs 1 and 2 drawn by the weights
        for g, w in zip(got, want, strict=True):
            _same(g, w)
    assert got.epoch == want.epoch == 3
    # index 1 has weight 0: never drawn as a base image
    idx = np.random.default_rng(3 + 1).choice(6, 6, p=WEIGHTS /
                                              WEIGHTS.sum())
    assert 1 not in idx
    assert not hasattr(ploader.RectLoader, "set_image_weights")


def test_trainer_reweights_each_epoch(data, tmp_path, monkeypatch):
    """Two epochs of mosaic batches with ``image_weights``: after the
    first evaluation (its per-class AP set to 0.4 for class 0, mAP 0.2,
    so that class 1, not evaluated, takes the mean), the loader gets
    ``labels_to_image_weights(labels, 2, cw * (1 - maps) ** 2)`` and the
    second epoch's base images are ``default_rng(seed + 1).choice(n, n,
    p=w / w.sum())``; no reweighting after the last epoch."""
    yaml_path = data[0]
    given, drawn, evals = [], [], []

    class Loader(ploader.MosaicLoader):
        def set_image_weights(self, weights):
            given.append(np.array(weights))
            super().set_image_weights(weights)

        def _indices(self, rng):
            drawn.append(super()._indices(rng))
            return drawn[-1]
    real_eval = trainer.evaluate

    def evaluate(*a, **kw):
        res = real_eval(*a, **kw)
        res = dataclasses.replace(res, map=0.2, per_class={
            "box": {"ap": 0.4}})
        evals.append(res)
        return res
    monkeypatch.setattr(trainer, "MosaicLoader", Loader)
    monkeypatch.setattr(trainer, "evaluate", evaluate)
    out = trainer.train(trainer.TrainConfig(
        model="yolov5t_add", data=yaml_path, epochs=2, batch_size=2,
        img_size=48, workdir=str(tmp_path / "exp"), dtype="float32",
        autoanchor=False, workers=0, warmup_floor=1, seed=5,
        image_weights=True), device="cpu")
    assert len(evals) == 2 and len(given) == 1 and len(drawn) == 2
    labels = data[1].labels
    maps = np.array([0.4, 0.2])
    cw = labels_to_class_weights(labels, 2)
    np.testing.assert_array_equal(
        given[0], labels_to_image_weights(labels, 2, cw * (1 - maps) ** 2))
    np.testing.assert_array_equal(drawn[0],
                                  np.random.default_rng(5).permutation(6))
    w = given[0] / given[0].sum()
    np.testing.assert_array_equal(
        drawn[1], np.random.default_rng(5 + 1).choice(6, 6, p=w))
    assert [e["epoch"] for e in out["epochs"]] == [0, 1]
