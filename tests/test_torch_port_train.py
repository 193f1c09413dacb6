"""The port's training path against the JAX package's, on the CPU in f32:
the schedules, the optimizer groups and gradient accumulation (SGD and
Adam against optax ``MultiSteps``), the EMA, BatchNorm in train mode,
three train steps against ``make_train_step``, and the trainer end to end
(the batches it stepped on, through JAX's step and schedules, across a
``--resume``; its checkpoint through the port's val CLI).  JAX compiles
``yolov5s_add`` at 64 px, batch 2 (its train step once, for two tests).
The detector's aux losses are in ``tests/test_torch_port_aux.py``."""

import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.train import ema as jema
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu.train import schedule as jsched
from mmidet_tpu.train.step import init_state as jax_init_state
from mmidet_tpu.train.step import make_train_step as jax_make_train_step
from mmidet_tpu_torch.bridge import from_jax_variables, torch_key
from mmidet_tpu_torch.cli import val
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.train import optimizer as popt
from mmidet_tpu_torch.train import schedule as psched
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.train.checkpoint import checkpoints
from mmidet_tpu_torch.train.ema import ModelEMA
from mmidet_tpu_torch.train.step import init_state, make_train_step

# f32 on both sides, the same operations in another order of sums
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# yolov5s_add's raw outputs in train mode, per level within 1e-3 of
# max(1, max |want|): flax takes BN's variance as E[x^2] - E[x]^2, and
# through ~60 layers JAX's f32 run sits 3e-4..7e-4 from an f64 run of the
# port, the port's f32 run 5e-5..1.4e-4 (measured on this model and batch)
BN_OUT_TOL = 1e-3
# how far parameters, BN statistics and EMA moved in a few steps: per
# tensor, max |port change - JAX change| within MOVE_TOL of JAX's largest
# change of that tensor (MOVE_FLOOR where that is smaller).  The steps run
# at lr 1e-3: at the defaults (lr0 0.01, bias warmup from 0.1) the seeded
# model's dynamics amplify rounding tenfold a step (the port's own f32 run
# against its f64 run: 2e-5, 1.3e-4, 2.3e-3, 4.5e-2 after steps 1-4),
# which no tolerance can separate from a fault
MOVE_TOL = 5e-2
MOVE_FLOOR = 1e-6
# the trainer's run, the settings the JAX step below is compiled with:
# batch 2 at 64 px, 2 steps an epoch, 2 epochs, accumulate 1, lr 1e-3
SCHED = jsched.ScheduleConfig(epochs=2, steps_per_epoch=2, warmup_floor=1,
                              lr0=0.001, warmup_bias_lr=0.001)
MAX_LABELS = 120


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_shapes(model, img=64):
    x = jnp.zeros((1, img, img, 3))
    return jax.eval_shape(
        lambda k: model.init({"params": k}, x, x, train=False),
        jax.random.PRNGKey(0))


def _seeded(shapes, seed):
    """Variables from numpy without a JAX init: kernels N(0, 1/fan-in), BN
    variances in U(0.5, 1.5), scales 1 + N(0, 0.1), the rest N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "conv_kernel_s2d"):
            v = rng.normal(0, np.sqrt(1.0 / np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("scale", "sobel_factor"):
            v = 1.0 + rng.normal(0, 0.1, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return jnp.asarray(v.astype(np.float32))
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _to_torch(arr, kind):
    from mmidet_tpu_torch.bridge import to_torch_layout
    return to_torch_layout(np.asarray(arr), kind)


def _from_port(template: dict, sd: dict) -> dict:
    """Port state dict -> JAX variables shaped as ``template``."""
    inverse = {"conv": lambda a: np.transpose(a, (2, 3, 1, 0)),
               "linear": lambda a: a.T, "factor": lambda a: a.reshape(-1),
               "raw": lambda a: a}

    def fill(path, _):
        key, kind = torch_key(tuple(p.key for p in path))
        return jnp.asarray(inverse[kind](
            sd[key].detach().cpu().numpy()).copy())
    return {c: jax.tree_util.tree_map_with_path(fill, template[c])
            for c in ("params", "batch_stats")}


def _check_tree(jtree: dict, sd: dict, tol: float, what=""):
    """Every leaf of JAX's tree against the port tensor the bridge maps it
    to, within ``tol`` of max(1, max |want|)."""
    worst = 0.0
    leaves = {p: v for tree in jtree.values()
              for p, v in flax.traverse_util.flatten_dict(tree).items()}
    for path, leaf in leaves.items():
        key, kind = torch_key(path)
        want = _to_torch(leaf, kind)
        got = sd[key].detach().cpu().numpy()
        err = float(np.abs(got - want).max()) / max(1.0, float(
            np.abs(want).max()))
        assert err <= tol, (what, key, err)
        worst = max(worst, err)
    return worst


def _check_moves(jtree: dict, sd: dict, sd0: dict, what=""):
    """Every leaf of JAX's tree after some steps, as a change from the
    weights both sides started from (``sd0``, the port's state dict), against
    the port's change of the tensor the bridge maps it to: per tensor
    max |difference| / max(max |JAX change|, MOVE_FLOOR) <= MOVE_TOL.
    Returns {key: (share, max |JAX change|)}."""
    out = {}
    leaves = {p: v for tree in jtree.values()
              for p, v in flax.traverse_util.flatten_dict(tree).items()}
    for path, leaf in leaves.items():
        key, kind = torch_key(path)
        base = sd0[key].detach().cpu().numpy()
        want = _to_torch(leaf, kind) - base
        got = sd[key].detach().cpu().numpy() - base
        top = float(np.abs(want).max())
        # the stored values' own rounding: two units in the last place
        ulp = 2 * float(np.spacing(np.abs(base + want).max()))
        share = max(float(np.abs(got - want).max()) - ulp, 0.0) / max(
            top, MOVE_FLOOR)
        assert share <= MOVE_TOL, (what, key, share, top)
        out[key] = (share, top)
    return out


@pytest.fixture(scope="module")
def add_pair():
    """yolov5s_add: the JAX model and seeded variables, and the port model
    with the same weights."""
    jmodel = JaxDetector(spec=jax_get_spec("yolov5s_add", nc=2),
                         aux_mode="reference")
    variables = _seeded(_jax_shapes(jmodel), 0)
    port = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                             aux_mode="reference")
    from_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, port


def _anchors(spec):
    a = np.asarray(spec.anchors, np.float32).reshape(spec.nl, spec.na, 2)
    return a / np.asarray(spec.strides, np.float32)[:, None, None]


@pytest.fixture(scope="module")
def jax_step(add_pair):
    """JAX's train step for the trainer's settings (compiled once)."""
    jmodel, variables, _ = add_pair
    tx, _ = jopt.build_optimizer(variables["params"], SCHED, 0.0005,
                                 total_batch_size=2, nbs=2)
    step = jax.jit(jax_make_train_step(
        jmodel, tx, jnp.asarray(_anchors(jmodel.spec)), JaxLossHyp()))
    return tx, step


def _batch(seed, n_targets=3):
    rng = np.random.default_rng(seed)
    targets = np.zeros((2, MAX_LABELS, 5), np.float32)
    targets[:, :n_targets, 0] = rng.integers(0, 2, (2, n_targets))
    targets[:, :n_targets, 1:3] = rng.uniform(0.2, 0.8, (2, n_targets, 2))
    targets[:, :n_targets, 3:] = rng.uniform(0.1, 0.4, (2, n_targets, 2))
    mask = np.zeros((2, MAX_LABELS), bool)
    mask[:, :n_targets] = True
    return {"rgb": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
            "ir": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
            "targets": targets, "mask": mask}


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("linear", [False, True])
def test_schedules_match_jax_per_step(linear):
    cfg = dict(epochs=5, steps_per_epoch=7, warmup_epochs=1.5,
               warmup_floor=3, linear_lr=linear, lrf=0.1)
    jc, pc = jsched.ScheduleConfig(**cfg), psched.ScheduleConfig(**cfg)
    assert pc.warmup_steps == jc.warmup_steps == 10  # round(10.5)
    for start in (0.0, 0.1):  # the bn/weight groups, the bias group
        jf, pf = jsched.lr_schedule(jc, start), psched.lr_schedule(pc, start)
        for s in range(5 * 7 + 2):
            assert pf(s) == pytest.approx(float(jf(s)), rel=1e-6, abs=1e-9)
    jm, pm = jsched.momentum_schedule(jc), psched.momentum_schedule(pc)
    for s in range(20):
        assert pm(s) == pytest.approx(float(jm(s)), rel=1e-6)
    for acc in (1, 4):
        assert dataclasses.asdict(popt._opt_step_sched(pc, acc)) == \
            dataclasses.asdict(jopt._opt_step_sched(jc, acc))


# ----------------------------------------------------------------- groups

@pytest.mark.parametrize("groups,freeze", [("fixed", ()),
                                           ("reference", ()),
                                           ("fixed", ("l2_", "l10_"))])
def test_label_params_match_jax_through_the_bridge(groups, freeze,
                                                   add_pair):
    """yolov5s_add's labels (``tests/test_torch_port_aux.py`` holds the
    fourier grammar's, with ``pos_emb``)."""
    _, variables, port = add_pair
    want = {torch_key(p)[0]: v for p, v in flax.traverse_util.flatten_dict(
        jopt.label_params(variables["params"], groups, freeze)).items()}
    # the port's freeze substrings are the same layers by its own names
    pfreeze = tuple(f"model.{f[1:-1]}." for f in freeze)
    got = popt.label_params(port, groups, pfreeze)
    for p in port.parameters():  # labels only; nothing is frozen here
        assert p.requires_grad
    assert got == want
    assert set(got.values()) >= {"bn", "weight", "bias"}
    assert ("frozen" in got.values()) == (groups == "reference"
                                          or bool(freeze))


# the first stages and the CEM: every kind of leaf (Focus's kernel, conv
# kernels, BN scales and biases, the CEM's sobel_factor) at a cheap compile
HEAD = ("enhance", "l0_Focus", "l1_Conv", "l2_C3", "l3_Conv")


class _Head(torch.nn.Module):
    """The port's modules of ``HEAD``, under their names in the model."""

    def __init__(self, port):
        super().__init__()
        self.Enhance = port.Enhance
        self.model = torch.nn.ModuleList(port.model[:4])


def _head_pair(add_pair):
    _, variables, port0 = add_pair
    port = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                             aux_mode="reference")
    port.load_state_dict(port0.state_dict())
    sub = {c: {k: v for k, v in variables[c].items() if k in HEAD}
           for c in ("params", "batch_stats")}
    assert set(sub["params"]) == set(HEAD)
    return sub, _Head(port)


def _random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 1, p.shape).astype(np.float32)),
        params)


@pytest.mark.parametrize("adam", [False, True])
def test_optimizer_with_accumulation_matches_optax_multisteps(adam,
                                                              add_pair):
    """4 micro-steps of random gradients, accumulate 2 (batch 2, nbs 4):
    gradient sums, the groups' decay, the schedules in optimizer steps."""
    variables, port = _head_pair(add_pair)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    sched = jsched.ScheduleConfig(epochs=3, steps_per_epoch=4,
                                  warmup_epochs=0.5, warmup_floor=2)
    build_j = jopt.build_adam if adam else jopt.build_optimizer
    build_p = popt.build_adam if adam else popt.build_optimizer
    params = variables["params"]
    tx, _ = build_j(params, sched, 0.05, total_batch_size=2, nbs=4)
    opt, labels = build_p(port, psched.ScheduleConfig(
        **dataclasses.asdict(sched)), 0.05, total_batch_size=2, nbs=4)
    assert opt.accumulate == 2

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    state = tx.init(params)
    named = dict(port.named_parameters())
    flat_keys = {p: torch_key(p) for p in
                 flax.traverse_util.flatten_dict(params)}
    for micro in range(4):
        grads = _random_grads(params, micro)
        params, state = update(grads, state, params)
        for path, g in flax.traverse_util.flatten_dict(grads).items():
            key, kind = flat_keys[path]
            t = torch.from_numpy(_to_torch(g, kind).copy())
            p = named[key]
            p.grad = t if p.grad is None else p.grad + t
        if (micro + 1) % opt.accumulate == 0:
            opt.step((micro + 1) // opt.accumulate - 1)
    worst = _check_tree({"params": params}, port.state_dict(), 1e-5,
                        "params")
    assert worst > 0 or adam  # something moved by a rounding at least
    moved = sum(not torch.equal(port.state_dict()[k], before[k])
                for k, v in labels.items() if v != "frozen")
    assert moved == len(labels)


def test_ema_matches_jax(add_pair):
    variables, port = _head_pair(add_pair)
    ema_j = jema.ema_init(variables["params"], variables["batch_stats"])
    ema_p = ModelEMA(port, decay=0.9999)
    for i in range(3):
        new = _seeded(variables, 10 + i)
        ema_j = jema.ema_update(ema_j, new["params"], new["batch_stats"])
        from_jax_variables(port, jax.tree_util.tree_map(np.asarray, new))
        ema_p.update(port)
    assert ema_p.updates == int(ema_j["updates"]) == 3
    _check_tree({"params": ema_j["params"],
                 "batch_stats": ema_j["batch_stats"]},
                ema_p.state_dict(), 1e-6, "ema")


# ------------------------------------------------------- train-mode model

def test_batchnorm_train_mode_matches_jax(add_pair):
    """yolov5s_add in train mode (no dropout there): the raw outputs and
    the updated running_mean and running_var (biased batch variance,
    momentum 0.03) against JAX's ``train=True``."""
    jmodel, variables, port0 = add_pair
    port = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                             aux_mode="reference")
    port.load_state_dict(port0.state_dict())
    b = _batch(1)
    out, mutated = jax.jit(lambda v, r, i: jmodel.apply(
        v, r, i, train=True, decode=False, mutable=["batch_stats"]))(
        variables, b["rgb"], b["ir"])
    got = port.train()(torch.from_numpy(b["rgb"]), torch.from_numpy(b["ir"]))
    assert got["pred"] is None
    for g, w in zip(got["train_outs"], out["train_outs"]):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= BN_OUT_TOL * max(
            1.0, np.abs(w).max())
    _check_tree({"batch_stats": mutated["batch_stats"]}, port.state_dict(),
                1e-5, "batch_stats")
    # the update is flax's biased variance, not torch's unbiased one
    bn = port.model[0].conv.bn
    assert int(bn.num_batches_tracked) == 1


# ------------------------------------------------------------ train steps

def test_three_train_steps_match_jax(add_pair, jax_step):
    """Three steps of ``yolov5s_add`` in train mode through
    ``make_train_step`` (accumulate 1: three optimizer steps, the first at
    the weights' warmup lr 0): metrics per step, then how far the
    parameters, BN statistics and EMA moved."""
    jmodel, variables, port0 = add_pair
    tx, step = jax_step
    port = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                             aux_mode="reference")
    port.load_state_dict(port0.state_dict())
    sd0 = {k: v.clone() for k, v in port.state_dict().items()}
    opt, _ = popt.build_optimizer(port, psched.ScheduleConfig(
        **dataclasses.asdict(SCHED)), 0.0005, total_batch_size=2, nbs=2)
    pstate = init_state(port, opt)
    pstep = make_train_step(torch.from_numpy(_anchors(jmodel.spec)))
    jstate = jax_init_state(jmodel, tx, None, None, None,
                            variables=variables)
    for i in range(3):
        b = _batch(20 + i)
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(0))
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6)
    assert pstate.opt_step == 3 and pstate.ema.updates == 3
    _check_moves({"params": jstate.params,
                  "batch_stats": jstate.batch_stats}, port.state_dict(), sd0,
                 "state")
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 pstate.ema.state_dict(), sd0, "ema")


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_synth")
    return make_synthetic_pair_dataset(str(root), n=4, img=64)


ZERO_AUG = {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "fliplr": 0.0,
            "translate": 0.0, "scale": 0.0,
            "lr0": SCHED.lr0, "warmup_bias_lr": SCHED.warmup_bias_lr}


def trainer_against_jax(data: str, pairs: int, nbs: int, add_pair, tx,
                        step, tmp_path, monkeypatch):
    """``train`` on ``data``'s ``pairs`` pairs at 64 px, batch 2, zero
    augmentation, ``notest``: one epoch, then ``--resume`` in place to a
    second.  The batches both runs stepped on, from the first run's initial
    weights, through JAX's ``step`` (compiled with ``tx`` for the two-epoch
    run: epoch 0's lr does not depend on the number of epochs) give how
    far the resumed run's parameters, BN statistics and EMA moved.  The
    best checkpoint evaluates through the port's val CLI."""
    jmodel, variables, _ = add_pair
    accumulate, steps = nbs // 2, pairs // 2
    seen = {"batches": []}
    real_make = trainer.make_train_step

    def recording(*a, **kw):
        inner = real_make(*a, **kw)

        def rec(state, batch):
            if "init" not in seen:
                seen["init"] = {k: v.clone() for k, v in
                                state.model.state_dict().items()}
            seen["batches"].append({k: v.numpy().copy()
                                    for k, v in batch.items()})
            return inner(state, batch)
        return rec
    monkeypatch.setattr(trainer, "make_train_step", recording)
    cfg = trainer.TrainConfig(
        model="yolov5s_add", data=data, hyp=dict(ZERO_AUG), epochs=1,
        batch_size=2, img_size=64, workdir=str(tmp_path / "exp"),
        mosaic_prob=0.0, dtype="float32", nbs=nbs, warmup_floor=1,
        notest=True, workers=0)
    out = trainer.train(cfg, device="cpu")
    assert [e["epoch"] for e in out["epochs"]] == [0]
    assert len(seen["batches"]) == steps
    assert all(b["targets"].shape == (2, MAX_LABELS, 5)
               for b in seen["batches"])
    last = torch.load(checkpoints(os.path.join(out["workdir"], "ckpt"))[-1],
                      weights_only=True)
    assert ("grads" in last) == (steps % accumulate != 0)

    # --resume: the run dir continues in place with the next epoch
    again = trainer.train(dataclasses.replace(cfg, resume=out["workdir"],
                                              epochs=2), device="cpu")
    assert again["workdir"] == out["workdir"]
    assert [e["epoch"] for e in again["epochs"]] == [1]
    state = again["state"]
    assert len(seen["batches"]) == state.micro_step == 2 * steps
    assert state.opt_step == state.ema.updates == 2 * steps // accumulate
    jstate = jax_init_state(jmodel, tx, None, None, None,
                            variables=_from_port(variables, seen["init"]))
    for b in seen["batches"]:
        jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(0))
    _check_moves({"params": jstate.params,
                  "batch_stats": jstate.batch_stats},
                 state.model.state_dict(), seen["init"], "state")
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 state.ema.state_dict(), seen["init"], "ema")
    with open(os.path.join(out["workdir"], "results.txt")) as fh:
        assert [ln.split()[0] for ln in fh] == ["0/0", "1/1"]
    with open(os.path.join(out["workdir"], "opt.yaml")) as fh:
        assert yaml.safe_load(fh)["model"] == "yolov5s_add"

    # the best checkpoint through the val CLI on the CPU
    best = checkpoints(os.path.join(out["workdir"], "ckpt_best"))
    assert len(best) == 1
    missing = val.load_weights(
        TwoStreamDetector(get_model_spec("yolov5s_add", nc=2)),
        val.load_state_dict_file(best[0]))
    assert missing == []
    res = val.main(["--cfg", "yolov5s_add", "--data", data,
                    "--weights", best[0], "--img-size", "64",
                    "--batch-size", "2"], device="cpu")
    assert all(np.isfinite([res.mp, res.mr, res.map50, res.map]))


def test_trainer_end_to_end_against_jax(data_yaml, tmp_path, add_pair,
                                        jax_step, monkeypatch):
    """The trainer, accumulate 1, on 4 pairs (``trainer_against_jax``);
    ``tests/test_torch_port_resume.py`` resumes between two optimizer
    steps."""
    trainer_against_jax(data_yaml, 4, 2, add_pair, *jax_step, tmp_path,
                        monkeypatch)


def test_unported_options_raise_naming_their_roadmap_item(tmp_path):
    """The data-parallel modes (A13) are ported: ``n_model`` 2 on the one
    CPU device is the JAX trainer's ``ValueError`` (``setup_mesh``), and
    ``mesh="on"`` there is one process, which gets past the check to the
    dataset YAML, as do the options ported before (image weights, W&B,
    artifacts, the bucket upload, bbox media); the YAML does not exist
    here."""
    base = trainer.TrainConfig(data=str(tmp_path / "unused.yaml"),
                               workdir=str(tmp_path / "x"))
    with pytest.raises(ValueError, match="n_model=2 > 1 devices"):
        trainer.train(dataclasses.replace(base, n_model=2), device="cpu")
    for kw in ({"mesh": "on"}, {"image_weights": True}, {"use_wandb": True},
               {"log_artifacts": True}, {"bucket": "gs://b"},
               {"bbox_interval": 1}):
        with pytest.raises(FileNotFoundError, match="unused.yaml"):
            trainer.train(dataclasses.replace(base, **kw), device="cpu")
