"""The port's ``MetricLogger`` against the JAX package's on the CPU: the
JSONL lines (``time`` aside), the TensorBoard (tag, step, value) triples
read back from both event files, a fake ``wandb`` module receiving the
same calls from both, and both going on without wandb; then the port's
trainer with ``bbox_interval``, ``use_wandb`` (the fake) and ``bucket`` (a
recording stub ``gsutil`` first on ``PATH``) on a tiny model."""

import glob
import json
import os
import stat
import sys
import types

import numpy as np
import pytest
import torch

from mmidet_tpu.utils.logger import MetricLogger as JaxLogger
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.utils.logger import MetricLogger

METRICS = [{"train/box": np.float32(0.125), "val/mAP": 0.5, "fitness": 1},
           {"train/box": 0.0625, "val/mAP": np.float64(0.75),
            "fitness": 2.5}]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class FakeWandb(types.ModuleType):
    """Records every call a logger makes; ``dir`` is the run dir."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))
        return self

    def log(self, data, step=None):
        self.calls.append(("log", data, step))

    def Image(self, path):  # noqa: N802 (wandb's name)
        return ("Image", os.path.basename(path))

    def finish(self):
        self.calls.append(("finish",))


def _drive(logger, media):
    for step, m in enumerate(METRICS):
        logger.log_metrics(step, m)
    logger.log_image(1, "batch", np.full((8, 8, 3), 7, np.uint8))
    logger.log_media_files(1, "val/bbox", media)
    logger.close()


def _events(log_dir):
    from tensorboard.backend.event_processing.event_file_loader import \
        EventFileLoader
    from tensorboard.util import tensor_util
    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    scalars, images = [], []
    for e in EventFileLoader(path).Load():
        for v in e.summary.value:
            plugin = v.metadata.plugin_data.plugin_name
            if plugin == "images" or v.HasField("image"):
                images.append((v.tag, e.step))
            else:
                scalars.append((v.tag, e.step, float(
                    tensor_util.make_ndarray(v.tensor))))
    return sorted(scalars), sorted(images)


def test_jsonl_and_tensorboard_against_jax(tmp_path):
    media = [str(tmp_path / "a.jpg")]
    for cls, d in ((MetricLogger, "port"), (JaxLogger, "jax")):
        _drive(cls(str(tmp_path / d)), media)
    lines = {}
    for d in ("port", "jax"):
        with open(tmp_path / d / "metrics.jsonl") as fh:
            recs = [json.loads(l) for l in fh]
        assert all(isinstance(r.pop("time"), float) for r in recs)
        lines[d] = recs
    assert lines["port"] == lines["jax"]
    assert lines["port"][1] == {"step": 1, "train/box": 0.0625,
                                "val/mAP": 0.75, "fitness": 2.5}
    port, jax_ = _events(str(tmp_path / "port")), _events(str(tmp_path /
                                                              "jax"))
    assert port[0] == jax_[0] and len(port[0]) == 6
    assert port[1] == jax_[1] == [("batch", 1)]


def test_wandb_calls_against_jax(tmp_path, monkeypatch):
    calls = {}
    media = [str(tmp_path / "val_000.jpg"), str(tmp_path / "val_001.jpg")]
    for cls, d in ((MetricLogger, "port"), (JaxLogger, "jax")):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        _drive(cls(str(tmp_path / d), use_wandb=True, project="proj",
                   run_name="exp3", config={"epochs": 2}, entity="team"),
               media)
        init = fake.calls[0][1]
        assert init.pop("dir") == str(tmp_path / d)
        calls[d] = fake.calls
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", {"project": "proj", "name": "exp3",
                                         "entity": "team",
                                         "config": {"epochs": 2}})
    assert calls["port"][-2] == ("log", {"val/bbox": [
        ("Image", "val_000.jpg"), ("Image", "val_001.jpg")]}, 1)


def test_without_wandb_both_go_on(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    for cls, d in ((MetricLogger, "port"), (JaxLogger, "jax")):
        log = cls(str(tmp_path / d), use_wandb=True, entity="team")
        assert log._wandb is None
        _drive(log, [str(tmp_path / "x.jpg")])


def _gsutil_stub(tmp_path):
    d = tmp_path / "bin"
    d.mkdir()
    log = tmp_path / "gsutil.log"
    exe = d / "gsutil"
    exe.write_text(f"#!{sys.executable}\nimport sys\n"
                   f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) "
                   f"+ '\\n')\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return d, log


def test_trainer_bbox_interval_wandb_and_bucket(tmp_path, monkeypatch):
    """Two epochs with ``bbox_interval=1``: annotated val images every
    epoch, handed to W&B as media; ``bucket``: ``results.txt`` uploaded
    after each evaluation."""
    data = make_synthetic_pair_dataset(str(tmp_path / "data"), n=4, img=64)
    stub, log = _gsutil_stub(tmp_path)
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    cfg = trainer.TrainConfig(
        model="yolov5t_add", data=data, epochs=2, batch_size=2, img_size=64,
        workdir=str(tmp_path / "runs" / "exp"), mosaic_prob=0.0,
        dtype="float32", autoanchor=False, workers=0, warmup_floor=1,
        bbox_interval=1, use_wandb=True, entity="team", bucket="bkt")
    out = trainer.train(cfg, device="cpu")
    wd = out["workdir"]
    for epoch in (0, 1):
        jpgs = sorted(glob.glob(os.path.join(wd, "media", f"epoch{epoch}",
                                             "*.jpg")))
        assert len(jpgs) == 4
        assert ("log", {"val/bbox": [("Image", os.path.basename(p))
                                     for p in jpgs]}, epoch) in fake.calls
    init = fake.calls[0]
    assert init[0] == "init" and init[1]["name"] == "exp" and \
        init[1]["entity"] == "team" and init[1]["config"]["epochs"] == 2
    assert fake.calls[-1] == ("finish",)
    results = os.path.join(wd, "results.txt")
    assert log.read_text().splitlines() == [f"cp {results} gs://bkt/"] * 2
    with open(os.path.join(wd, "metrics.jsonl")) as fh:
        assert [json.loads(l)["step"] for l in fh] == [0, 1]
    assert glob.glob(os.path.join(wd, "events.out.tfevents.*"))
