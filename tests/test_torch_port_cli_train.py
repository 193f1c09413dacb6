"""The port's train CLI (``cli/train.py``) on the CPU: one epoch, mosaic by
default, and its options (the val and detect CLIs and the state-dict
loaders are ``test_torch_port_cli.py``'s)."""

import os

import numpy as np
import pytest
import torch

from mmidet_tpu_torch.cli import train, val
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec

from test_torch_port_cli import _two_threads, data_yaml  # noqa: F401


def test_train_cli_one_epoch(data_yaml, tmp_path, capsys):
    """``cli.train --no-mosaic`` for one epoch (the smoke flags of
    ``tests/test_cli.py``): a checkpoint per epoch, the best one, the
    results line, and a best checkpoint the val CLI reads."""
    out = train.main(["--cfg", "yolov5s_add", "--data", data_yaml,
                      "--epochs", "1", "--batch-size", "2", "--img-size",
                      "64", "--project", str(tmp_path / "runs"), "--name",
                      "exp", "--no-mosaic", "--dtype", "float32",
                      "--workers", "0"], device="cpu")
    wd = out["workdir"]
    assert wd == str(tmp_path / "runs" / "exp")
    assert os.listdir(os.path.join(wd, "ckpt")) == ["epoch0.pt"]
    assert os.listdir(os.path.join(wd, "ckpt_best")) == ["epoch0.pt"]
    lines = open(os.path.join(wd, "results.txt")).read().splitlines()
    assert len(lines) == 1 and lines[0].startswith("0/0 box ")
    assert all(np.isfinite(out["epochs"][0][k])
               for k in ("box", "obj", "cls", "aux"))
    assert "done: best fitness" in capsys.readouterr().out
    ck = torch.load(os.path.join(wd, "ckpt_best", "epoch0.pt"),
                    weights_only=True)
    assert {"model", "ema", "optimizer", "step", "epoch", "best_fitness",
            "fitness"} <= set(ck)
    assert val.load_weights(TwoStreamDetector(get_model_spec(
        "yolov5s_add", nc=2)), val.load_state_dict_file(
        os.path.join(wd, "ckpt_best", "epoch0.pt"))) == []


def test_train_cli_trains_with_mosaic_by_default(data_yaml, tmp_path,
                                                 monkeypatch):
    """``cli.train`` without ``--no-mosaic``: one epoch on mosaic batches
    (``MosaicLoader``, the mosaic augmentation); ``--quad``,
    ``--multi-scale`` and ``--rect`` reach the trainer."""
    from mmidet_tpu_torch.train import trainer
    made, cfgs, real_loader = [], [], trainer.MosaicLoader

    def loader(*a, **kw):
        made.append(real_loader(*a, **kw))
        return made[-1]
    monkeypatch.setattr(trainer, "MosaicLoader", loader)
    out = train.main(["--cfg", "yolov5s_add", "--data", data_yaml,
                      "--epochs", "1", "--batch-size", "2", "--img-size",
                      "64", "--project", str(tmp_path / "runs"), "--name",
                      "exp", "--dtype", "float32", "--workers", "0"],
                     device="cpu")
    assert len(made) == 1 and made[0].epoch == 1
    assert np.isfinite(out["epochs"][0]["box"])
    monkeypatch.setattr(train, "train", lambda cfg, device: cfgs.append(
        cfg) or {"best_fitness": 0.0, "workdir": ""})
    train.main(["--data", data_yaml, "--quad", "--multi-scale",
                "--multi-scale-buckets", "5", "--rect"], device="cpu")
    assert (cfgs[0].quad, cfgs[0].multi_scale, cfgs[0].multi_scale_buckets,
            cfgs[0].rect, cfgs[0].mosaic_prob) == (True, True, 5, True, 1.0)


@pytest.mark.parametrize("args,item", [
    (["--entity", "team"], "A15"),
    (["--log-artifacts"], "A15"),
    (["--artifact-alias", "v1"], "A15"),
    (["--resume", "wandb-artifact://p/run1"], "A15"),
    (["--no-mosaic", "--mesh", "on"], "A13"),
    (["--no-mosaic", "--n-model", "2"], "A13"),
    (["--no-mosaic", "--image-weights"], "A15"),
    (["--no-mosaic", "--evolve", "2"], "A15"),
    (["--no-mosaic", "--upload-dataset"], "A15"),
    (["--no-mosaic", "--bucket", "gs://b"], "A15"),
    (["--no-mosaic", "--bbox-interval", "1"], "A15"),
])
def test_train_cli_unported_options_raise(data_yaml, tmp_path, args, item,
                                         monkeypatch):
    """The A13 and A15 options are ported: the CLI hands each to the
    trainer (``--evolve`` runs its generations through it); ``--n-model
    2`` on the one CPU device is the JAX trainer's ``ValueError``
    (``setup_mesh``), raised before anything is written."""
    if args[-2:] == ["--n-model", "2"]:
        with pytest.raises(ValueError, match="n_model=2 > 1 devices"):
            train.main(["--cfg", "yolov5s_add", "--data", data_yaml,
                        "--project", str(tmp_path), *args], device="cpu")
        assert not (tmp_path / "exp").exists()
        return
    cfgs = []
    monkeypatch.setattr(train, "train", lambda cfg, device: cfgs.append(
        cfg) or {"best_fitness": float(len(cfgs)), "workdir": ""})
    out = train.main(["--cfg", "yolov5s_add", "--data", data_yaml,
                      "--project", str(tmp_path), *args], device="cpu")
    flag = args[-2] if args[-1] not in ("--image-weights",
                                        "--upload-dataset",
                                        "--log-artifacts") else args[-1]
    field = flag.lstrip("-").replace("-", "_")
    if field == "evolve":
        assert len(cfgs) == 2 and out["best_fitness"] == 2.0
        assert all(c.workdir.endswith("exp_gen") and isinstance(c.hyp, dict)
                   for c in cfgs)
        return
    want = {"entity": "team", "artifact_alias": "v1",
            "resume": "wandb-artifact://p/run1", "bucket": "gs://b",
            "bbox_interval": 1, "mesh": "on"}.get(field, True)
    assert len(cfgs) == 1 and getattr(cfgs[0], field) == want
