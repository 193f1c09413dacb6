"""Hyperparameter evolution in the port against the JAX package on the
CPU: ``mutate`` bit for bit (a single parent, a weighted combination, no
history), ``evolve`` with a deterministic ``train_fn`` writing the same
``evolve.txt`` (and resuming from it), ``plot_lr_schedule``'s samples
against JAX's ``lr_schedule``, ``plot_evolve``, and the train CLI's
``--evolve 2`` on a tiny model."""

import json
import os

import numpy as np
import pytest
import torch

from mmidet_tpu.train import evolve as jevo
from mmidet_tpu.train import schedule as jsched
from mmidet_tpu_torch.cli import train as train_cli
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.train import evolve as pevo
from mmidet_tpu_torch.train import schedule as psched
from mmidet_tpu_torch.train.trainer import DEFAULT_HYP
from mmidet_tpu_torch.utils import plots


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _history(n, seed):
    rng = np.random.default_rng(seed)
    return [(float(rng.random()), {k: float(v * rng.uniform(0.5, 1.5))
                                   for k, v in DEFAULT_HYP.items()})
            for _ in range(n)]


@pytest.mark.parametrize("parent,n", [("single", 0), ("single", 1),
                                      ("single", 7), ("weighted", 7),
                                      ("weighted", 1)])
def test_mutate_against_jax(parent, n):
    assert pevo.META == jevo.META
    hist = _history(n, n)
    for seed in range(3):
        got = pevo.mutate(DEFAULT_HYP, hist, np.random.default_rng(seed),
                          parent)
        want = jevo.mutate(DEFAULT_HYP, hist, np.random.default_rng(seed),
                           parent)
        assert got == want
        for k, (_, lo, hi) in pevo.META.items():
            assert lo <= got[k] <= hi


def _fitness(hyp):
    return hyp["lr0"] * 10 + hyp["momentum"] - hyp["mosaic"] / 7


def test_evolve_against_jax(tmp_path):
    for mod, d in ((pevo, "port"), (jevo, "jax")):
        best = mod.evolve(_fitness, DEFAULT_HYP, generations=3,
                          workdir=str(tmp_path / d), seed=4)
        # a second call continues from the history on disk
        best2 = mod.evolve(_fitness, DEFAULT_HYP, generations=2,
                           workdir=str(tmp_path / d), seed=5)
        assert best2[0] >= best[0]
    port = (tmp_path / "port" / "evolve.txt").read_text()
    assert port == (tmp_path / "jax" / "evolve.txt").read_text()
    assert len(port.splitlines()) == 5
    assert plots.plot_evolve(str(tmp_path / "port" / "evolve.txt")) == \
        str(tmp_path / "port" / "evolve.png")
    assert os.path.isfile(tmp_path / "port" / "evolve.png")


def test_lr_schedule_samples_against_jax(tmp_path):
    kw = dict(lr0=0.01, lrf=0.2, momentum=0.937, warmup_epochs=3.0,
              warmup_momentum=0.8, warmup_bias_lr=0.1, epochs=30,
              steps_per_epoch=50, warmup_floor=100)
    for linear in (False, True):
        ps = psched.ScheduleConfig(linear_lr=linear, **kw)
        js = jsched.ScheduleConfig(linear_lr=linear, **kw)
        xs, ys = plots.lr_curve(ps)
        fn = jsched.lr_schedule(js)
        assert len(xs) == 500 and xs[1] == 3
        # the schedules' own gate (test_torch_port_train.py): JAX's jnp
        # f32 arithmetic rounds the warmup ramp one ulp apart at places
        np.testing.assert_allclose(ys, [float(fn(x)) for x in xs],
                                   rtol=1e-6, atol=1e-9)
    out = str(tmp_path / "lr.png")
    assert plots.plot_lr_schedule(ps, out) == out and os.path.isfile(out)


def test_train_cli_evolve(tmp_path):
    """``--evolve 2``: two one-epoch runs under ``<name>_gen``, the
    history in ``<name>_evolve/evolve.txt``, each generation's hyp what
    ``mutate`` gives for the seed and the history before it."""
    data = make_synthetic_pair_dataset(str(tmp_path / "data"), n=4, img=64)
    out = train_cli.main(
        ["--cfg", "yolov5t_add", "--data", data, "--epochs", "1",
         "--batch-size", "2", "--img-size", "64", "--project",
         str(tmp_path / "runs"), "--name", "exp", "--dtype", "float32",
         "--workers", "0", "--noautoanchor", "--no-mosaic", "--evolve", "2",
         "--warmup-floor", "1"], device="cpu")
    with open(tmp_path / "runs" / "exp_evolve" / "evolve.txt") as fh:
        rows = [json.loads(l) for l in fh]
    assert [r["gen"] for r in rows] == [0, 1]
    rng, history = np.random.default_rng(0), []
    for r in rows:
        assert r["hyp"] == pevo.mutate(DEFAULT_HYP, history, rng)
        history.append((r["fitness"], r["hyp"]))
    assert sorted(os.listdir(tmp_path / "runs")) == ["exp_evolve", "exp_gen",
                                                     "exp_gen2"]
    assert out["best_fitness"] == max(r["fitness"] for r in rows)
