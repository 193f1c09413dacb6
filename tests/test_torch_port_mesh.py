"""The port's data and tensor parallelism (``mmidet_tpu_torch/parallel``,
the trainer over a mesh, ``evaluate`` and ``BatchingService`` over several
devices) against the JAX package on the CPU, in f32.

Ranks are gloo processes with one thread each, launched twice, by the
trainer: ``yolov5s_add`` at 64 px, global batch 4, three steps at lr
1e-3, over data 2 and over data 2 x model 2 (``tp_min_out`` 64, so that
the model axis holds shards).  The 2 x 2 run is held against the JAX
package's sharded step (``shard_train_state``, the batch placed by
``batch_sharding`` on a 2 x 2 mesh of the conftest's CPU devices),
compiled once, ahead of time, in a thread while the trainer's ranks run;
the data 2 run against the port's one-process step; the 2 x 2 run's
checkpoint resumes on one process for JAX's next step.

After the trainer, the same ranks run ``torch_mesh_ranks``' checks of what
``yolov5s_add`` does not run, each against one process: the terms that
couple samples (the aux losses of the fusion blocks, the pattern term,
BatchNorm, dropout) on the two ranks, and one f64 step of the flagship's
grammar (GPT1_fourier, GPT, CEM, the aux terms) over data 2 and over
2 x 2, held tensor by tensor.  The mesh rules without ranks are
``test_torch_port_mesh_rules.py``'s."""

import concurrent.futures
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp
from mmidet_tpu.parallel import mesh as jmesh
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu.train import schedule as jsched
from mmidet_tpu.train.step import init_state as jax_init_state
from mmidet_tpu.train.step import make_train_step as jax_make_train_step
from mmidet_tpu_torch.data.augment import AugmentHyp, make_batch_augment
from mmidet_tpu_torch.data.datasets import PairedDataset
from mmidet_tpu_torch.data.loader import PairedLoader
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.deploy import serve
from mmidet_tpu_torch.eval.evaluator import evaluate
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.parallel import launch as launch_mod
from mmidet_tpu_torch.parallel.mesh import tp_modules
from mmidet_tpu_torch.train import optimizer as popt
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.train.checkpoint import checkpoints, restore_checkpoint
from mmidet_tpu_torch.train.step import init_state, make_train_step
from mmidet_tpu_torch.utils import plots
from test_torch_port_train import (ZERO_AUG, _anchors, _check_moves,  # noqa
                                   _jax_shapes, _threads, add_pair)
import torch_mesh_ranks as ranks

B, STEPS, IMG = 4, 3, 64
# the JAX step's schedule: the trainer's (3 steps an epoch, lr 1e-3), two
# epochs; epoch 0's lr and momentum do not depend on the number of epochs
SCHED = jsched.ScheduleConfig(epochs=2, steps_per_epoch=STEPS,
                              warmup_floor=1, lr0=0.001,
                              warmup_bias_lr=0.001)
# the data 2 run against one process, by how far each tensor moved (as
# ``_check_moves``): the mesh's BatchNorm takes its statistics as sums
# over the ranks where one process runs torch's kernel, so the two differ
# by the order of f32 sums.  One f32 step of a BN scale near 1 is 1.2e-7,
# about 1% of its change over three steps at lr 1e-3 (measured: up to 1.3%
# of a tensor's change, on BN scales; everything else below 1%)
DP_MOVE_TOL = 2.5e-2
DP_MOVE_FLOOR = 1e-6
# the f64 step of the flagship's grammar against one process: each
# tensor's change within 1e-9 of itself (3e-13 seen); the tensors whose
# gradient is 0 by symmetry (the attention's key biases, a LayerNorm bias
# before a 2 x 2 map) move by 1e-20 of rounding, held against the floor
F64_MOVE_TOL = 1e-9
F64_MOVE_FLOOR = 1e-9


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_data")
    return make_synthetic_pair_dataset(str(root), n=B * STEPS, img=IMG)


def _dataset(data: str, cache_dir) -> PairedDataset:
    return PairedDataset(*(os.path.join(os.path.dirname(data),
                                        f"train_{m}", "images")
                           for m in ("rgb", "ir")), nc=2,
                         cache_dir=str(cache_dir))


@pytest.fixture(scope="module")
def jax_step(add_pair):
    """A future of JAX's sharded step (compiled ahead of time for the
    trainer's batches: ``B`` images, 120 label rows), the 2 x 2 mesh of
    the conftest's CPU devices, the state placed on it by
    ``shard_train_state`` and the batch sharding; built in a thread, so
    that the compile overlaps the trainer's launches."""
    jmodel, variables, _ = add_pair

    def build():
        tx, _ = jopt.build_optimizer(variables["params"], SCHED, 0.0005,
                                     total_batch_size=B, nbs=B)
        mesh = jmesh.make_mesh(2, 2, jax.devices()[:4])
        jstate = jmesh.shard_train_state(
            jax_init_state(jmodel, tx, None, None, None,
                           variables=variables), mesh, tp_min_out=64)
        bsh = jmesh.batch_sharding(mesh)
        like = {k: jax.ShapeDtypeStruct(shape, dt, sharding=bsh)
                for k, shape, dt in (
                    ("rgb", (B, IMG, IMG, 3), jnp.float32),
                    ("ir", (B, IMG, IMG, 3), jnp.float32),
                    ("targets", (B, 120, 5), jnp.float32),
                    ("mask", (B, 120), jnp.bool_))}
        step = jax.jit(jax_make_train_step(
            jmodel, tx, jnp.asarray(_anchors(jmodel.spec)), JaxLossHyp()))
        return (step.lower(jstate, like, jax.random.PRNGKey(0)).compile(),
                mesh, jstate, bsh)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build)
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def run(tmp_path_factory, add_pair, data, jax_step):
    """The data 2 and the 2 x 2 trainer runs from the seeded weights (the
    ranks with one thread each) with their ranks' checks after them
    (``checks``: the global terms and the f64 step over data 2, the f64
    step over 2 x 2), the global batches they stepped on, and the weights
    they started from."""
    _, _, port0 = add_pair
    root = tmp_path_factory.mktemp("mesh")
    weights = str(root / "init.pt")
    torch.save(port0.state_dict(), weights)
    cfg = trainer.TrainConfig(
        model="yolov5s_add", data=data, hyp=dict(ZERO_AUG), epochs=1,
        batch_size=B, img_size=IMG, workdir=str(root / "d2"),
        mosaic_prob=0.0, dtype="float32", nbs=B, warmup_floor=1,
        notest=True, workers=0, autoanchor=False, weights=weights)
    metrics = []
    real_make = trainer.make_train_step

    def recording(*a, **kw):  # rank 0's metrics: the global batch's
        inner = real_make(*a, **kw)

        def rec(state, batch, group=None):
            out = inner(state, batch, group)
            metrics.append({k: float(v) for k, v in out.items()})
            return out
        return rec
    real_launch = launch_mod.launch
    checks, done = [], []

    def with_checks(fn, args, devices, store_dir, local_kwargs=None):
        out, results = real_launch(ranks.after_train,
                                   (fn, args, checks.pop(0)), devices,
                                   store_dir, local_kwargs)
        done.append(results)
        return out
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the spawned ranks take the caller's count
    try:
        with pytest.MonkeyPatch.context() as mp:
            # rank 0's plots (seconds of matplotlib) are not under test
            mp.setattr(plots, "plot_labels", lambda *a, **k: None)
            mp.setattr(plots, "plot_results", lambda *a, **k: None)
            mp.setattr(launch_mod, "launch", with_checks)
            checks.append([(ranks.global_terms, ()), (ranks.f64_step, (2, 1))])
            d2 = trainer.train(cfg, device="cpu", devices=["cpu"] * 2)
            mp.setattr(trainer, "make_train_step", recording)
            checks.append([(ranks.f64_step, (2, 2))])
            tp = trainer.train(dataclasses.replace(
                cfg, workdir=str(root / "tp"), n_model=2, tp_min_out=64),
                device="cpu", devices=["cpu"] * 4)
    finally:
        torch.set_num_threads(threads)
    (terms, f64_d2), (f64_tp,) = done

    # the batches: the one-process trainer's loader and augmentation
    hyp = trainer.load_hyp(cfg.hyp)
    loader = PairedLoader(_dataset(data, root), B, IMG, 120, shuffle=True,
                          seed=cfg.seed, prefetch=0)
    augment = make_batch_augment(IMG, AugmentHyp(**{k: hyp[k] for k in (
        "hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
        "perspective", "flipud", "fliplr", "mosaic")}), 120, mosaic=False)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    batches = []
    for epoch in (0, 1):
        loader.epoch = epoch
        for b in loader:
            jb = {k: torch.from_numpy(b[k]) for k in
                  ("rgb", "ir", "targets", "mask")}
            jb["rgb"], jb["ir"] = jb["rgb"].float() / 255, \
                jb["ir"].float() / 255
            batches.append(augment(jb, gen))
    return {"cfg": cfg, "hyp": hyp, "d2": d2, "tp": tp, "metrics": metrics,
            "batches": batches, "sd0": port0.state_dict(), "terms": terms,
            "f64": {"data2": f64_d2, "2x2": f64_tp}}


def _port_state(cfg, hyp, sd0, epochs: int):
    """A one-process train state from ``sd0`` with the trainer's
    optimizer and schedule."""
    model = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                              aux_mode="reference")
    model.load_state_dict(sd0)
    sched, loss_hyp = trainer.build_sched_and_loss(
        dataclasses.replace(cfg, epochs=epochs), hyp, STEPS)
    opt, _ = popt.build_optimizer(model, sched, hyp["weight_decay"],
                                  total_batch_size=B, nbs=cfg.nbs)
    step = make_train_step(trainer.anchors_grid(model.spec), loss_hyp)
    return init_state(model, opt), step


def test_mesh_runs_match_jax_and_one_process(run, jax_step):
    """2 x 2 against JAX's sharded steps: the metrics of every step (rtol
    1e-4) and how far each parameter, BN statistic and EMA tensor moved
    (``_check_moves``, 5%); data 2 against the port's one process."""
    assert run["d2"]["mesh"] == {"data": 2, "model": 1, "backend": "gloo"}
    assert run["tp"]["mesh"] == {"data": 2, "model": 2, "backend": "gloo"}
    step, mesh, jstate, bsh = jax_step.result()
    jm = []
    for b in run["batches"][:STEPS]:
        jstate, m = step(jstate, {k: jax.device_put(v.numpy(), bsh)
                                  for k, v in b.items()},
                         jax.random.PRNGKey(0))
        # back on the placement the step was compiled for
        jstate = jmesh.shard_train_state(jstate, mesh, tp_min_out=64)
        jm.append(m)
    assert len(run["metrics"]) == STEPS
    for got, want in zip(run["metrics"], jm):
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                       atol=1e-6)
    state = run["tp"]["state"]
    assert state.opt_step == state.ema.updates == STEPS
    sd0 = run["sd0"]
    _check_moves({"params": jstate.params,
                  "batch_stats": jstate.batch_stats},
                 state.model.state_dict(), sd0, "2x2")
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 state.ema.state_dict(), sd0, "2x2 ema")

    # data 2 against one process on the same batches
    one, pstep = _port_state(run["cfg"], run["hyp"], sd0, 1)
    for b in run["batches"][:STEPS]:
        pstep(one, b)
    d2 = run["d2"]["state"]
    for what, got, want in (
            ("model", d2.model.state_dict(), one.model.state_dict()),
            ("ema", d2.ema.state_dict(), one.ema.state_dict())):
        for k, w in want.items():
            if not w.is_floating_point():
                assert torch.equal(got[k], w), k
                continue
            moved = (w - sd0[k]).abs().max().item()
            # the stored values' own rounding: two units in the last place
            ulp = 2 * float(np.spacing(np.float32(w.abs().max().item())))
            err = (got[k] - w).abs().max().item() - ulp
            assert err <= DP_MOVE_TOL * max(moved, DP_MOVE_FLOOR), \
                (what, k, err, moved)

    # the 2 x 2 checkpoint (whole tensors) resumes on one process and
    # takes JAX's next step
    ck = os.path.join(run["tp"]["workdir"], "ckpt")
    assert len(checkpoints(ck)) == 1
    resumed, pstep = _port_state(run["cfg"], run["hyp"], sd0, 2)
    resumed, _, meta = restore_checkpoint(ck, resumed)
    assert meta["epoch"] == 0 and resumed.opt_step == STEPS
    nxt = run["batches"][STEPS]
    pstep(resumed, nxt)
    jstate, _ = step(jstate, {k: jax.device_put(v.numpy(), bsh)
                              for k, v in nxt.items()},
                     jax.random.PRNGKey(0))
    _check_moves({"params": jstate.params,
                  "batch_stats": jstate.batch_stats},
                 resumed.model.state_dict(), sd0, "resumed")
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 resumed.ema.state_dict(), sd0, "resumed ema")


def test_global_batch_terms_over_two_ranks(run):
    """Every term that couples samples, on two gloo ranks holding 2 rows
    each, against one process on the 4 rows: the contrastive pairs across
    the rank boundary, the SSIM moments and unbiased stds, the soft
    histograms, the pattern term's rows, train-mode BatchNorm (output and
    running statistics) and the dropout masks of the global batch (the
    same generator).  Values within 1e-5; each rank's input gradients,
    over the ranks' count (``comm``'s convention: every rank
    backpropagates the global loss), within 1e-5 of one process's."""
    two = run["terms"]
    x = {k: v.requires_grad_() for k, v in ranks.term_inputs().items()}
    one = ranks.terms(x, None, lambda g: g)
    for got, want in zip(two, one):
        for k, w in want.items():
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert all(g.abs().sum() > 0 for g in one[1].values())


@pytest.mark.parametrize("mesh", ["data2", "2x2"])
def test_f64_flagship_grammar_step_per_tensor(run, mesh):
    """One f64 step of the flagship's grammar (GPT1_fourier at P2 with its
    high-frequency rows, GPT at P3-P5, CEM, the contrastive, fusing and
    entropy terms; dropout off) on the trainer's ranks, over data 2 and
    over 2 x 2 (most layers sharded, the attention's heads among them),
    against one process on the whole batch: every tensor of the model and
    of the EMA moved as one process moved it, within ``F64_MOVE_TOL``."""
    state, step = ranks.f64_state()
    sd0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    step(state, ranks.f64_batch())
    assert len(tp_modules(state.model, 2, ranks.F64_TP_MIN_OUT)) > 50
    got = run["f64"][mesh]
    for what, want in (("model", state.model.state_dict()),
                       ("ema", state.ema.state_dict())):
        assert set(got[what]) == set(want)
        for k, w in want.items():
            g = got[what][k]
            if not w.is_floating_point():
                assert torch.equal(g, w), (what, k)
                continue
            assert g.dtype == torch.float64, (what, k)
            moved = (w - sd0[k]).abs().max().item()
            err = (g - w).abs().max().item()
            assert err <= F64_MOVE_TOL * max(moved, F64_MOVE_FLOOR), \
                (what, k, err, moved)


def _same_records(want: list, got: list) -> None:
    """The same detections; their numbers within an f32 step or two: the
    forward has no cross-example math, but the CPU's convolutions block
    their work by batch size, so a sample's scores can round otherwise in
    a batch of 3 than in one of 5 (seen: 3e-8 on a score of 0.31)."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert {k: v for k, v in w.items() if isinstance(v, (int, str))} \
            == {k: v for k, v in g.items() if isinstance(v, (int, str))}
        for k, v in w.items():
            if isinstance(v, (float, list)):
                np.testing.assert_allclose(g[k], v, rtol=1e-6, atol=1e-5)


def test_evaluate_and_batching_over_two_devices(add_pair, data, tmp_path):
    """``evaluate`` over ``["cpu", "cpu"]`` at batch 5 (12 images: a ragged
    last batch of 2, padded) and ``BatchingService`` over the same give one
    device's metrics and records."""
    _, _, port0 = add_pair
    model = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2)).eval()
    model.load_state_dict(port0.state_dict())
    ds = _dataset(data, tmp_path)
    out = {}
    for name, devs in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        path = str(tmp_path / f"{name}.json")
        res = evaluate(model, PairedLoader(ds, 5, IMG, drop_last=False,
                                           prefetch=0),
                       2, conf_thres=0.01, device="cpu", devices=devs,
                       save_json=path)
        with open(path) as fh:
            out[name] = (res.map50, res.map, res.mp, res.mr, json.load(fh))
    assert out["one"][:4] == out["two"][:4] and out["one"][-1]
    _same_records(out["one"][-1], out["two"][-1])

    folded = fold_batchnorm(model)
    svc = {k: serve.BatchingService(folded, ["a", "b"], img_size=IMG,
                                    conf_thres=1e-3, max_batch=4,
                                    max_wait_ms=200.0, device="cpu",
                                    devices=devs)
           for k, devs in (("one", None), ("two", ["cpu", "cpu"]))}
    assert svc["two"].model.__class__.__name__ == "ShardedModel"
    rng = np.random.default_rng(0)
    from test_torch_port_serve import _png
    imgs = [_png(rng.integers(0, 255, (48, 64, 3), np.uint8))
            for _ in range(3)]
    for s in svc.values():
        got = [None] * 3
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, s.predict(imgs[i], imgs[i]))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        s.records = got
        s.close()
    assert any(svc["one"].records)
    for a, b in zip(svc["one"].records, svc["two"].records):
        _same_records(a, b)
