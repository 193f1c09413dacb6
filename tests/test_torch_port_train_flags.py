"""The trainer's options of the JAX package's training that the port runs
since mosaic (its default) came: the trainer with mosaic on, its batches
replayed through JAX's train step; ``quad``, ``multi_scale`` (the sizes
JAX's stream draws) and ``rect`` (JAX's ``RectLoader`` train shapes) by
the batches the steps saw; ``remat`` "full" and "dots", one step against
JAX's ``make_train_step(remat=...)`` and equal to the port's own plain
step, dropout and BatchNorm's running buffers included.  On the CPU in
f32 at 64 px; JAX compiles ``yolov5s_add``'s step once, with remat
"full": a policy changes what is recomputed, not what is computed, so
both of the port's policies and the trainer's replay are held against
that one step (and the port's "dots" step equals its plain step)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmidet_tpu.data import datasets as jds
from mmidet_tpu.data import loader as jloader
from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu.train import trainer as jtrainer
from mmidet_tpu.train.step import init_state as jax_init_state
from mmidet_tpu.train.step import make_train_step as jax_make_train_step
from mmidet_tpu_torch.data import loader as ploader
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.train import optimizer as popt
from mmidet_tpu_torch.train import schedule as psched
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.train.step import init_state, make_train_step
from test_torch_port_data import rect  # noqa: F401
from test_torch_port_train import (MAX_LABELS, SCHED,  # noqa: F401
                                   _anchors, _batch, _check_moves,
                                   _from_port, _threads, add_pair)


@pytest.fixture(scope="module")
def jax_remat(add_pair):  # noqa: F811
    """The optimizer of the trainer's settings (``SCHED``) and JAX's train
    step with remat "full"."""
    jmodel, variables, _ = add_pair
    tx, _ = jopt.build_optimizer(variables["params"], SCHED, 0.0005,
                                 total_batch_size=2, nbs=2)
    return tx, jax.jit(jax_make_train_step(
        jmodel, tx, jnp.asarray(_anchors(jmodel.spec)), JaxLossHyp(),
        remat="full"))


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("flags_synth")
    return make_synthetic_pair_dataset(str(root), n=4, img=64)


def _recording(monkeypatch, snapshot_after=0):
    """Record the initial weights and every batch the train steps get, and
    the model's and the EMA's state after step ``snapshot_after``."""
    seen = {"batches": []}
    real_make = trainer.make_train_step

    def make(*a, **kw):
        inner = real_make(*a, **kw)

        def rec(state, batch):
            if "init" not in seen:
                seen["init"] = {k: v.clone() for k, v in
                                state.model.state_dict().items()}
            seen["batches"].append({k: v.numpy().copy()
                                    for k, v in batch.items()})
            metrics = inner(state, batch)
            if len(seen["batches"]) == snapshot_after:
                seen["snapshot"] = tuple(
                    {k: v.clone() for k, v in sd.items()} for sd in
                    (state.model.state_dict(), state.ema.state_dict()))
            return metrics
        return rec
    monkeypatch.setattr(trainer, "make_train_step", make)
    return seen


def _cfg(data, tmp_path, **kw):
    base = dict(model="yolov5s_add", data=data, epochs=1, batch_size=2,
                img_size=64, workdir=str(tmp_path / "exp"),
                dtype="float32", notest=True, workers=0)
    return trainer.TrainConfig(**{**base, **kw})


def test_trainer_with_mosaic_against_jax(data_yaml, tmp_path, add_pair,
                                         jax_remat, monkeypatch):
    """``train`` with the JAX package's defaults (mosaic on, its default
    hyp) at lr 1e-3 (``SCHED``; ``tests/test_torch_port_train.py`` says
    why), two epochs of 2 steps on 4 pairs through ``MosaicLoader``.  The
    first epoch's batches, from the first step's weights, through JAX's
    step (compiled for 2 epochs, as the run) give how far the parameters,
    BN statistics and EMA moved by the end of that epoch; all four batches
    through the port's plain step give exactly the trainer's final state.
    JAX holds the first epoch only: at the third step one channel of the
    SPP's 2x2 max pools has its two largest values 5e-5 apart, the port's
    f32 rounding moves its maximum to another pixel and the f64 gradient
    there moves by 41%, so the second epoch leaves the gate by chance
    (``tests/mosaic_replay_drift.py`` reads it)."""
    jmodel, variables, _ = add_pair
    tx, step = jax_remat
    seen = _recording(monkeypatch, snapshot_after=2)
    made = []

    def loader(*a, **kw):
        made.append(ploader.MosaicLoader(*a, **kw))
        return made[-1]
    monkeypatch.setattr(trainer, "MosaicLoader", loader)
    out = trainer.train(_cfg(data_yaml, tmp_path, epochs=2, nbs=2,
                             warmup_floor=1, hyp={
                                 "lr0": SCHED.lr0,
                                 "warmup_bias_lr": SCHED.warmup_bias_lr}),
                        device="cpu")
    assert len(made) == 1 and made[0].epoch == 2
    assert [e["batches"] for e in out["epochs"]] == [2, 2]
    batches = seen["batches"]
    assert len(batches) == 4
    for b in batches:
        assert b["rgb"].shape == b["ir"].shape == (2, 64, 64, 3)
        assert b["targets"].shape == (2, MAX_LABELS, 5)
        assert 0.0 <= b["rgb"].min() and b["rgb"].max() <= 1.0
    assert sum(int(b["mask"].sum()) for b in batches) > 0
    state = out["state"]
    assert state.opt_step == state.ema.updates == 4
    jstate = jax_init_state(jmodel, tx, None, None, None,
                            variables=_from_port(variables, seen["init"]))
    for b in batches[:2]:
        jstate, _ = step(
            jstate, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(0))
    model_sd, ema_sd = seen["snapshot"]
    _check_moves({"params": jstate.params,
                  "batch_stats": jstate.batch_stats},
                 model_sd, seen["init"], "state")
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 ema_sd, seen["init"], "ema")
    port = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                             aux_mode="reference")
    port.load_state_dict(seen["init"])
    _same_state(_steps(port, "", batches)[0], state)


@pytest.mark.parametrize("img,gs,buckets", [(640, 32, 0), (640, 64, 0),
                                            (320, 32, 5), (64, 32, 0)])
def test_multi_scale_sizes_match_jax(img, gs, buckets):
    got = trainer.multi_scale_sizes(img, gs, buckets)
    np.testing.assert_array_equal(got, jtrainer.multi_scale_sizes(
        img, gs, buckets))
    assert (got % gs == 0).all()


def _rect_yaml(rect_dirs, tmp_path):
    rgb, ir = rect_dirs
    path = tmp_path / "rect.yaml"
    path.write_text(yaml.safe_dump({"train_rgb": rgb, "train_ir": ir,
                                    "val_rgb": rgb, "val_ir": ir, "nc": 2}))
    return str(path)


@pytest.mark.parametrize("option", ["quad", "multi_scale", "rect"])
def test_trainer_options_give_the_jax_packages_batches(
        option, rect, tmp_path, monkeypatch):  # noqa: F811
    """One epoch on 5 mixed-aspect pairs: the shapes of the batches the
    steps got.  ``quad`` (batch 4, mosaic): one sample at twice the size,
    4x the label rows; ``multi_scale``: the sizes the JAX trainer draws
    from ``default_rng(seed + 2)`` over its ``multi_scale_sizes``;
    ``rect`` (at 128 px, where stride 32 leaves room for non-square
    shapes): JAX's ``RectLoader`` train shapes (stride 32, pad 0,
    scale-up)."""
    data = _rect_yaml(rect, tmp_path)
    seen = _recording(monkeypatch)
    kw = {"quad": dict(quad=True, batch_size=4),
          "multi_scale": dict(multi_scale=True),
          "rect": dict(rect=True, mosaic_prob=1.0, img_size=128)}[option]
    out = trainer.train(_cfg(data, tmp_path, **kw), device="cpu")
    shapes = [b["rgb"].shape for b in seen["batches"]]
    assert [b["ir"].shape for b in seen["batches"]] == shapes
    assert np.isfinite(out["epochs"][0]["box"])
    if option == "quad":
        assert shapes == [(1, 128, 128, 3)]
        assert seen["batches"][0]["targets"].shape == (1, 4 * MAX_LABELS, 5)
        with pytest.raises(ValueError, match="divisible by 4"):
            trainer.train(_cfg(data, tmp_path, quad=True, batch_size=2),
                          device="cpu")
    elif option == "multi_scale":
        sizes = jtrainer.multi_scale_sizes(64, 32, 0)
        rng = np.random.default_rng(0 + 2)
        want = [int(rng.choice(sizes)) for _ in shapes]
        assert [s[1:3] for s in shapes] == [(w, w) for w in want]
        assert len(set(want)) > 1
    else:
        rgb, ir = rect
        want = jloader.RectLoader(
            jds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path / "j")),
            2, 128, 120, stride=32, pad=0.0, scaleup=True).shapes
        assert [s[1:3] for s in shapes] == want
        assert [s[0] for s in shapes] == [2, 2, 1]
        assert any(h != w for h, w in want)


def _steps(model, remat, batches, seed=0):
    """``len(batches)`` micro-steps at ``SCHED`` (accumulate 1), the global
    RNG seeded first; returns the state and the metrics."""
    opt, _ = popt.build_optimizer(model, psched.ScheduleConfig(
        **dataclasses.asdict(SCHED)), 0.0005, total_batch_size=2, nbs=2)
    state = init_state(model, opt)
    step = make_train_step(torch.from_numpy(_anchors(model.spec)),
                           remat=remat)
    torch.manual_seed(seed)
    return state, [step(state, {k: torch.from_numpy(v) for k, v in
                                b.items()}) for b in batches]


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    ea, eb = a.ema.state_dict(), b.ema.state_dict()
    assert all(torch.equal(ea[k], eb[k]) for k in ea)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_step_matches_jax_and_the_plain_step(remat, add_pair,
                                                   jax_remat):
    """Two steps of ``yolov5s_add`` (the weights' warmup lr 0, then lr0):
    against JAX's remat "full" step by how far every tensor moved, and
    equal to the port's step without remat; BN counts each batch once."""
    jmodel, variables, port0 = add_pair
    _, step = jax_remat
    batches = [_batch(40), _batch(41)]
    runs = {}
    for r in ("", remat):
        port = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                                 aux_mode="reference")
        port.load_state_dict(port0.state_dict())
        runs[r] = _steps(port, r, batches)
    _same_state(runs[""][0], runs[remat][0])
    state, metrics = runs[remat]
    bn = state.model.model[0].conv.bn
    assert int(bn.num_batches_tracked) == 2
    jstate = jax_init_state(jmodel, jax_remat[0], None, None, None,
                            variables=variables)
    for b, pm in zip(batches, metrics):
        jstate, jm = step(
            jstate, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(0))
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6)
    sd0 = port0.state_dict()
    _check_moves({"params": jstate.params,
                  "batch_stats": jstate.batch_stats},
                 state.model.state_dict(), sd0, "state")
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 state.ema.state_dict(), sd0, "ema")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_draws_the_same_dropout_masks(remat):
    """``yolov5t_gpt4`` (dropout 0.1 in its fusion transformers): a step
    with remat leaves the model, its BN buffers and the EMA exactly where
    the plain step does from the same seed, so the recomputation drew the
    same masks and updated BN once."""
    torch.manual_seed(0)
    port0 = TwoStreamDetector(get_model_spec("yolov5t_gpt4", nc=2),
                              aux_mode="reference")
    assert any(isinstance(m, torch.nn.Dropout) and m.p > 0
               for m in port0.modules())
    runs = {r: _steps(copy.deepcopy(port0), r, [_batch(42)], seed=7)
            for r in ("", remat)}
    _same_state(runs[""][0], runs[remat][0])
    assert int(runs[remat][0].model.model[0].conv.bn.num_batches_tracked) \
        == 1
    # another seed draws other masks: the loss moves
    _, metrics = _steps(copy.deepcopy(port0), remat, [_batch(42)], seed=8)
    assert float(metrics[0]["total"]) != float(runs[""][1][0]["total"])
