"""The port's ``utils/artifacts.py`` against the JAX package's on the CPU:
the same calls give the same store (files, ``.metadata.json``,
``aliases.json``), the same rewritten data dicts and run addressing, and
the same refusal of a finished run; then the port's trainer round trip
(``log_artifacts`` and ``upload_dataset``, then ``--resume
wandb-artifact://``), as the JAX package's ``tests/test_artifacts.py``
runs its own."""

import json
import os
import sys

import pytest
import torch
import yaml

from mmidet_tpu.utils import artifacts as jart
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.utils import artifacts as part


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return make_synthetic_pair_dataset(str(root), n=4, img=64)


def _tree(root):
    """{relative path: contents} of every file under ``root`` (JSON files
    parsed)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            with open(p, "rb") as fh:
                raw = fh.read()
            out[rel] = json.loads(raw) if f.endswith(".json") else raw
    return out


def _fill(base):
    ckpt = base / "ckpt"
    ckpt.mkdir(parents=True)
    (ckpt / "epoch0.pt").write_bytes(b"state0")
    (ckpt / "sub").mkdir()
    (ckpt / "sub" / "x.bin").write_bytes(b"x")
    (base / "preds.json").write_text("[]")
    return ckpt


def test_store_layout_against_jax(tmp_path):
    stores = {}
    for mod, d in ((part, "port"), (jart, "jax")):
        ckpt = _fill(tmp_path / f"src_{d}")
        be = mod.LocalBackend(root=str(tmp_path / d), project="proj")
        assert be.log_artifact("m", "model", {"ckpt": str(ckpt)},
                               metadata={"epochs_trained": 1}) == "v0"
        assert be.log_artifact("m", "model", {"ckpt": str(ckpt)},
                               aliases=("latest", "epoch 2", "best")) == "v1"
        be.log_artifact("p", "evaluation", {"a.json": str(
            tmp_path / f"src_{d}" / "preds.json")}, project="other")
        mod.log_model_artifact(be, "run7", str(ckpt), epoch=1,
                               total_epochs=3, fitness=0.6, project="proj",
                               opt={"epochs": 3})
        assert be.download("m:best").endswith(os.path.join("m", "v1"))
        assert be.download("proj/m:v0").endswith(os.path.join("m", "v0"))
        assert be.metadata("m:v0") == {"type": "model", "epochs_trained": 1}
        with pytest.raises(FileNotFoundError, match="no alias"):
            be.download("m:epoch 9")
        with pytest.raises(FileNotFoundError, match="not found"):
            be.download("nothing:latest")
        ck, meta = mod.resume_from_artifact(
            "wandb-artifact://proj/run7", be)
        assert ck.endswith(os.path.join("run_run7_model", "v0", "ckpt"))
        assert meta["total_epochs"] == 3 and meta["epochs_trained"] == 2
        stores[d] = _tree(tmp_path / d)
        # a run trained to its last epoch is not resumed
        mod.log_model_artifact(be, "run7", str(ckpt), epoch=2,
                               total_epochs=3, fitness=0.6, project="proj")
    assert stores["port"] == stores["jax"]
    assert stores["port"]["proj/m/aliases.json"] == {
        "latest": "v1", "epoch 2": "v1", "best": "v1"}
    for mod in (part, jart):
        with pytest.raises(AssertionError, match="finished"):
            mod.resume_from_artifact(
                "wandb-artifact://proj/run7",
                mod.LocalBackend(root=str(tmp_path / ("port" if mod is part
                                                      else "jax")),
                                 project="proj"))
    for p in ("wandb-artifact://proj/run7", "wandb-artifact://run7",
              "wandb-artifact://ent/proj/run7/"):
        assert part.get_run_info(p) == jart.get_run_info(p)


def test_dataset_artifacts_against_jax(synth, tmp_path):
    with open(synth) as fh:
        data = yaml.safe_load(fh)
    out = {}
    for mod, d in ((part, "port"), (jart, "jax")):
        be = mod.LocalBackend(root=str(tmp_path / d))
        rewritten = mod.log_dataset_artifact(
            data, be, out_yaml=str(tmp_path / f"{d}.yaml"))
        with open(tmp_path / f"{d}.yaml") as fh:
            assert yaml.safe_load(fh) == rewritten
        resolved = mod.resolve_data_artifacts(rewritten, be)
        out[d] = (rewritten, {k: os.path.relpath(v, tmp_path / d)
                              for k, v in resolved.items()
                              if k in mod.DATA_KEYS},
                  _tree(tmp_path / d))
    assert out["port"] == out["jax"]
    rewritten, resolved, tree = out["port"]
    assert rewritten["train_rgb"] == "wandb-artifact://mmidet_tpu/train_rgb"
    assert resolved["val_ir"] == os.path.join("mmidet_tpu", "val_ir", "v0",
                                              "data", "images")
    assert any(k.startswith("mmidet_tpu/train_rgb/v0/data/labels/")
               for k in tree)


def test_default_backend_without_wandb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setenv("MMIDET_ARTIFACT_ROOT", str(tmp_path))
    be = part.default_backend(project="p")
    assert isinstance(be, part.LocalBackend)
    assert be.root == str(tmp_path) and be.project == "p"
    monkeypatch.delenv("MMIDET_ARTIFACT_ROOT")
    assert part.LocalBackend().root.endswith(os.path.join(
        ".cache", "mmidet_tpu_torch", "artifacts"))


def test_trainer_artifact_resume_end_to_end(synth, tmp_path, monkeypatch):
    """One epoch with ``log_artifacts`` and ``upload_dataset``, then the
    run resumed from its ``wandb-artifact://`` reference: the epoch and
    the stored total epochs carry over through the store (the port's
    counterpart of the JAX package's test of the same name)."""
    monkeypatch.setenv("MMIDET_ARTIFACT_ROOT", str(tmp_path / "store"))
    base = dict(model="yolov5t_add", data=synth, batch_size=2, img_size=64,
                mosaic_prob=0.0, dtype="float32", autoanchor=False,
                workers=0, warmup_floor=1)
    out = trainer.train(trainer.TrainConfig(
        epochs=1, workdir=str(tmp_path / "runs" / "exp"), log_artifacts=True,
        upload_dataset=True, **base), device="cpu")
    run_id = os.path.basename(out["workdir"])
    store = part.LocalBackend(root=str(tmp_path / "store"))
    art = store.download(f"run_{run_id}_model:latest")
    meta = store.metadata(f"run_{run_id}_model:latest")
    assert meta["epochs_trained"] == 1 and meta["total_epochs"] == 1
    assert meta["opt"]["epochs"] == 1 and meta["opt"]["model"] == \
        "yolov5t_add"
    assert sorted(os.listdir(os.path.join(art, "ckpt"))) == ["epoch0.pt"]
    assert json.load(open(os.path.join(
        tmp_path, "store", "mmidet_tpu", f"run_{run_id}_model",
        "aliases.json"))) == {"latest": "v0", "epoch 1": "v0", "best": "v0"}
    prog = store.download(f"run_{run_id}_progress:latest")
    assert os.path.isfile(os.path.join(prog, "val_predictions.json"))
    assert "mAP50" in store.metadata(f"run_{run_id}_progress:latest")
    # the dataset went into the store and the run read it from there
    with open(os.path.join(out["workdir"], "data_wandb.yaml")) as fh:
        assert yaml.safe_load(fh)["val_rgb"] == \
            "wandb-artifact://mmidet_tpu/val_rgb"
    assert len(os.listdir(store.download("train_rgb:latest") +
                          "/data/images")) == 4

    # an interrupted longer run leaves this artifact: the same checkpoint
    # with total_epochs 2
    part.log_model_artifact(store, run_id, os.path.join(art, "ckpt"),
                            epoch=0, total_epochs=2, fitness=0.0,
                            opt={"epochs": 2})
    out2 = trainer.train(trainer.TrainConfig(
        epochs=5, notest=True, workdir=str(tmp_path / "runs" / "resumed"),
        resume=f"wandb-artifact://mmidet_tpu/{run_id}", **base),
        device="cpu")
    # total_epochs 2 from the artifact (not 5), continued at epoch 1
    assert [e["epoch"] for e in out2["epochs"]] == [1]
    with open(os.path.join(out2["workdir"], "results.txt")) as fh:
        assert fh.read().strip().splitlines()[-1].startswith("1/1")
