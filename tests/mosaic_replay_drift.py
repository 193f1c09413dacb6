"""Why the mosaic trainer's replay against JAX covers one epoch.

``tests/test_torch_port_train_flags.py::test_trainer_with_mosaic_against_jax``
trains ``yolov5s_add`` with mosaic on (64 px, batch 2, 4 pairs, lr 1e-3)
and holds the first epoch's two steps against JAX's step by how far every
tensor moved (``_check_moves``, 5%).  Over the second epoch the port's f32
run leaves its f64 replay by more than that gate while JAX's f32 run does
not.  This script shows where, in four readings per step:

1. the f32 runs against the f64 runs: the port's trainer (equal to its
   plain step's replay, asserted), the port in f64, JAX in f32 and JAX in
   f64 (``jax.enable_x64``), all on the trainer's batches from the same
   weights; per tensor max |change - f64 change| less two f32 units in
   the last place, over max(max |f64 change|, 1e-6);
2. the accuracy of each f32 gradient, at the port's f64 run's weights
   before the step, against the f64 gradient there;
3. the f64 gradient at each f32 run's weights against the f64 gradient at
   the f64 run's weights: how far the step's gradient moves when the
   weights move by the f32 run's rounding;
4. before each step but the first, the SPP block's max pools
   (``model.8``): at 64 px its input is 2x2, so each pooled channel is the
   largest of 4 values; at the f64 run's weights the smallest gap between
   a channel's two largest values (over the channel's largest |value|),
   and the gaps of the channels whose largest value changes place at each
   f32 run's weights.

Run from the repo root: ``JAX_PLATFORMS=cpu python
tests/mosaic_replay_drift.py`` (about two minutes on 4 cores).  Each step
prints one JSON line; the last line holds them all, the tensors of each
reading worst first.
"""

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp  # noqa: E402
from mmidet_tpu.losses.detection import \
    compute_loss as jax_compute_loss  # noqa: E402
from mmidet_tpu.models.detector import \
    TwoStreamDetector as JaxDetector  # noqa: E402
from mmidet_tpu.models.zoo import get_model_spec as jax_spec  # noqa: E402
from mmidet_tpu.train import optimizer as jopt  # noqa: E402
from mmidet_tpu.train.step import init_state as jax_init  # noqa: E402
from mmidet_tpu.train.step import \
    make_train_step as jax_make_step  # noqa: E402
from mmidet_tpu_torch.bridge import torch_key  # noqa: E402
from mmidet_tpu_torch.data.synthetic import \
    make_synthetic_pair_dataset  # noqa: E402
from mmidet_tpu_torch.losses.detection import LossHyp, compute_loss  # noqa
from mmidet_tpu_torch.models.detector import TwoStreamDetector  # noqa: E402
from mmidet_tpu_torch.models.zoo import get_model_spec  # noqa: E402
from mmidet_tpu_torch.train import optimizer as popt  # noqa: E402
from mmidet_tpu_torch.train import schedule as psched  # noqa: E402
from mmidet_tpu_torch.train import trainer  # noqa: E402
from mmidet_tpu_torch.train.step import init_state, make_train_step  # noqa
from test_torch_port_train import (MOVE_FLOOR, SCHED, _anchors,  # noqa: E402
                                   _from_port, _jax_shapes, _seeded,
                                   _to_torch)

F32, F64 = torch.float32, torch.float64


def port_model(sd, dtype):
    model = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                              aux_mode="reference")
    model.load_state_dict(sd)
    return model.to(dtype)


def to_port(trees) -> dict:
    """JAX params / batch_stats trees -> {port key: f64 tensor}."""
    out = {}
    for tree in trees:
        for path, leaf in flax.traverse_util.flatten_dict(tree).items():
            key, kind = torch_key(path)
            out[key] = torch.from_numpy(np.asarray(
                _to_torch(np.asarray(leaf, np.float64), kind)))
    return out


def train_recorded(data, workdir, epochs):
    """The trainer with the JAX package's defaults (mosaic on) at lr 1e-3,
    as the test runs it: its batches, initial weights and final state."""
    seen = {"batches": []}
    real_make = trainer.make_train_step

    def make(*a, **kw):
        inner = real_make(*a, **kw)

        def rec(state, batch):
            seen.setdefault("init", {k: v.clone() for k, v in
                                     state.model.state_dict().items()})
            seen["batches"].append({k: v.numpy().copy()
                                    for k, v in batch.items()})
            return inner(state, batch)
        return rec
    cfg = trainer.TrainConfig(
        model="yolov5s_add", data=data, epochs=epochs, batch_size=2,
        img_size=64, workdir=workdir, dtype="float32", notest=True,
        workers=0, nbs=2, warmup_floor=1,
        hyp={"lr0": SCHED.lr0, "warmup_bias_lr": SCHED.warmup_bias_lr})
    with mock.patch.object(trainer, "make_train_step", make):
        out = trainer.train(cfg, device="cpu")
    return seen["batches"], seen["init"], out["state"].model.state_dict()


def port_replay(init, batches, dtype):
    model = port_model(init, dtype)
    opt, _ = popt.build_optimizer(model, psched.ScheduleConfig(
        **dataclasses.asdict(SCHED)), 0.0005, total_batch_size=2, nbs=2)
    state = init_state(model, opt)
    step = make_train_step(torch.from_numpy(_anchors(model.spec)).to(dtype))
    states = []
    for b in batches:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb.update({k: tb[k].to(dtype) for k in ("rgb", "ir", "targets")})
        step(state, tb)
        states.append({k: v.detach().clone() for k, v in
                       model.state_dict().items()})
    return states


def jax_replay(jmodel, variables, init, batches, x64):
    ctx = jax.enable_x64(True) if x64 else contextlib.nullcontext()
    with ctx:
        dt = np.float64 if x64 else np.float32
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                   _from_port(variables, init))
        tx, _ = jopt.build_optimizer(v["params"], SCHED, 0.0005,
                                     total_batch_size=2, nbs=2)
        state = jax_init(jmodel, tx, None, None, None, variables=v)
        step = jax.jit(jax_make_step(jmodel, tx, jnp.asarray(
            _anchors(jmodel.spec), dt), JaxLossHyp()))
        states = []
        for b in batches:
            state, _ = step(state, {k: jnp.asarray(
                x.astype(dt) if x.dtype == np.float32 else x)
                for k, x in b.items()}, jax.random.PRNGKey(0))
            states.append(to_port((state.params, state.batch_stats)))
    return states


def shares(sd, ref, base):
    """Per tensor: max |change - ref change| less two f32 units in the
    last place of the stored values, over max(max |ref change|, 1e-6)."""
    out = {}
    for k, r in ref.items():
        if not r.is_floating_point() or k not in sd:
            continue
        b = base[k].double()
        want, got = r.double() - b, sd[k].double() - b
        ulp = 2 * float(np.spacing(np.float32(float((b + want).abs().max()))))
        out[k] = max(float((got - want).abs().max()) - ulp, 0.0) / max(
            float(want.abs().max()), MOVE_FLOOR)
    return out


def port_grad(sd, b, dtype):
    model = port_model(sd, dtype).train()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = model(tb["rgb"].to(dtype), tb["ir"].to(dtype))
    total, _ = compute_loss(
        out["train_outs"], tb["targets"].to(dtype), tb["mask"],
        torch.from_numpy(_anchors(model.spec)).to(dtype), LossHyp(),
        combine_loss=out["aux"].get("combine"))
    total.backward()
    return {k: p.grad.double() for k, p in model.named_parameters()}


def jax_grad(jmodel, variables, sd, b):
    v = _from_port(variables, sd)

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(b["rgb"]), jnp.asarray(b["ir"]), train=True,
            decode=False, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jax_compute_loss(
            tuple(out["train_outs"]), jnp.asarray(b["targets"]),
            jnp.asarray(b["mask"]), jnp.asarray(_anchors(jmodel.spec)),
            hyp=JaxLossHyp(), combine_loss=out["aux"].get("combine"))[0]
    return to_port((jax.jit(jax.grad(loss))(v["params"]),))


def rel(g, ref):
    return {k: float((g[k] - r).abs().max()) / max(float(r.abs().max()),
                                                   1e-30)
            for k, r in ref.items() if k in g}


def top(d, n=3):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def spp_input(sd, b):
    model = port_model(sd, F64).train()
    got = []
    hook = model.model[8].cv1.register_forward_hook(
        lambda m, i, o: got.append(o.detach()))
    with torch.no_grad():
        model(torch.from_numpy(b["rgb"]).double(),
              torch.from_numpy(b["ir"]).double())
    hook.remove()
    return got[0].flatten(2)


def main():
    torch.set_num_threads(4)
    jmodel = JaxDetector(spec=jax_spec("yolov5s_add", nc=2),
                         aux_mode="reference")
    variables = _seeded(_jax_shapes(jmodel), 0)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_pair_dataset(os.path.join(tmp, "d"), n=4,
                                           img=64)
        batches, init, trained = train_recorded(
            data, os.path.join(tmp, "exp"), 2)
    runs = {"port_f32": port_replay(init, batches, F32)}
    assert all(torch.equal(runs["port_f32"][-1][k], trained[k])
               for k in trained), "the trainer is not its plain replay"
    runs["port_f64"] = port_replay(init, batches, F64)
    runs["jax_f32"] = jax_replay(jmodel, variables, init, batches, False)
    runs["jax_f64"] = jax_replay(jmodel, variables, init, batches, True)
    p64 = runs["port_f64"]
    as64 = [{k: v.double() if v.is_floating_point() else v
             for k, v in s.items()} for s in p64]
    report = {"labels": [int(b["mask"].sum()) for b in batches],
              "steps": []}
    for i, b in enumerate(batches):
        row = {"step": i + 1}
        # 1. the runs against the f64 runs
        for name, run, ref in (("port_f32", "port_f32", "port_f64"),
                               ("jax_f32", "jax_f32", "port_f64"),
                               ("jax_f32_vs_jax_f64", "jax_f32", "jax_f64"),
                               ("jax_f64_vs_port_f64", "jax_f64",
                                "port_f64")):
            s = shares(runs[run][i], runs[ref][i], init)
            row[f"moves_{name}"] = top(s)
        # 2. f32 gradients at the f64 run's weights
        before = init if i == 0 else {**init, **{
            k: v.float() for k, v in as64[i - 1].items()
            if v.is_floating_point()}}
        g64 = port_grad(init if i == 0 else {**init, **as64[i - 1]}, b, F64)
        row["grad_port_f32"] = top(rel(port_grad(before, b, F32), g64))
        row["grad_jax_f32"] = top(rel(jax_grad(jmodel, variables, before,
                                               b), g64))
        # 3. the f64 gradient at the f32 runs' weights
        if i:
            for name in ("port_f32", "jax_f32"):
                at = {**init, **{k: v.double() for k, v in
                                 runs[name][i - 1].items()
                                 if v.is_floating_point()}}
                row[f"grad_f64_at_{name}_weights"] = top(
                    rel(port_grad(at, b, F64), g64))
        report["steps"].append(row)
        print(json.dumps(row))
    # 4. the SPP's max pools before each step but the first
    report["spp"] = []
    for i in range(1, len(batches)):
        x = spp_input({**init, **as64[i - 1]}, batches[i])
        two = x.topk(2, -1).values
        gap = (two[..., 0] - two[..., 1]) / x.abs().amax(-1)
        spp = {"step": i + 1, "channels": gap.numel(),
               "smallest_gap": float(gap.min())}
        for name in ("port_f32", "jax_f32"):
            xi = spp_input({**init, **{k: v.double() for k, v in
                                       runs[name][i - 1].items()
                                       if v.is_floating_point()}},
                           batches[i])
            moved = xi.argmax(-1) != x.argmax(-1)
            spp[f"argmax_moves_at_{name}_weights"] = [
                float(g) for g in gap[moved]]
        report["spp"].append(spp)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
