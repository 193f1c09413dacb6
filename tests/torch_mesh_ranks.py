"""What the ranks of ``tests/test_torch_port_mesh.py``'s two trainer
launches run after the trainer, on the same process group: the checks
that need 2 or 4 gloo ranks.  It imports torch and the port only, so that
a spawned rank starts without JAX.

  * ``terms``: the terms that couple samples (the aux losses of the
    fusion blocks, the pattern term, train-mode BatchNorm, dropout), each
    rank holding 2 of 4 rows, on the world's two ranks;
  * ``f64_step``: one f64 train step of the flagship's grammar
    (GPT1_fourier at P2, GPT at P3/P4/P5, CEM, the aux terms) at "t"
    width on an ``n_data`` x ``n_model`` mesh, the state gathered back
    whole.
"""

import dataclasses

import torch
import torch.distributed as dist

from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec
from mmidet_tpu_torch.parallel import comm
from mmidet_tpu_torch.parallel.mesh import (batch_rows, make_mesh,
                                            shard_train_state,
                                            unshard_train_state)
from mmidet_tpu_torch.train import optimizer as popt
from mmidet_tpu_torch.train import trainer
from mmidet_tpu_torch.train.step import init_state, make_train_step

F64_B, F64_IMG = 4, 64
F64_TP_MIN_OUT = 16   # shards most layers, the attention's heads included


def after_train(fn, args, checks, **kw):
    """``fn(*args, **kw)`` (the trainer's rank), then every ``check(*a)``
    of ``checks``; rank 0's (result, [check results])."""
    out = fn(*args, **kw)
    return out, [check(*a) for check, a in checks]


# ------------------------------------------------- terms that couple rows

def term_inputs() -> dict:
    g = torch.Generator().manual_seed(0)
    return {"rgb": torch.randn(4, 6, 5, 5, generator=g),
            "ir": torch.randn(4, 6, 5, 5, generator=g),
            "fused": torch.rand(4, 6, 5, 5, generator=g),
            "m": torch.rand(4 * 8, 7, generator=g)}   # 8 rows a sample


def terms(x: dict, group, gather) -> tuple:
    """The detector's aux terms, the pattern term, train-mode BatchNorm
    and dropout of ``x``: in ``group``'s data group, or (``group`` None)
    as one process: the functions' own code, and BatchNorm and dropout in
    a data group of one; values, input gradients (``gather``-ed), the BN's
    state."""
    from mmidet_tpu_torch.losses import fusion as fl
    from mmidet_tpu_torch.nn.fusion import Dropout, separation_loss
    from mmidet_tpu_torch.nn.layers import batchnorm
    g = torch.Generator().manual_seed(1)
    bn = batchnorm(6).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    drop = Dropout(0.5).train()
    ctx = group or comm.DataGroup(None, 0, 4,
                                  torch.Generator().manual_seed(5))

    def total(t):   # a sum over the global batch
        return t if group is None else comm.global_sum([t], group.group)[0]
    with comm.data_group(ctx):
        y = bn(x["rgb"])
        values = {
            "contrastive": fl.contrastive_loss(x["rgb"], x["ir"],
                                               group=group),
            "fusing": fl.fusing_loss(x["rgb"], x["ir"], x["fused"],
                                     x["fused"], group=group),
            "entropy": fl.entropy_loss(x["fused"], x["fused"] ** 2,
                                       x["fused"].sqrt(), soft=True,
                                       group=group),
            "separation": separation_loss(x["m"], group),
            "bn": total((y * y.detach().sign()).sum()) / y[0].numel() / 4,
            "dropout": total((drop(x["ir"]) * x["ir"]).sum())}
    grads = torch.autograd.grad(sum(values.values()), list(x.values()))
    return ({k: float(v.detach()) for k, v in values.items()},
            {k: gather(v) for k, v in zip(x, grads)},
            {k: v.clone() for k, v in bn.state_dict().items()})


def global_terms() -> tuple:
    """On each of the world's two ranks: its 2 rows of ``term_inputs``
    through ``terms`` in its data group; rank 0 gets every rank's input
    gradients, gathered."""
    r = dist.get_rank()
    group = comm.DataGroup(dist.group.WORLD, 2 * r, 4,
                           torch.Generator().manual_seed(5))
    rows = {k: v[2 * r * len(v) // 4:(2 * r + 2) * len(v) // 4].clone()
            .requires_grad_() for k, v in term_inputs().items()}
    return terms(rows, group, lambda g: comm.all_gather_cat(
        g / 2, dist.group.WORLD))


# ------------------------------------------------------ the f64 flagship

def f64_batch() -> dict:
    g = torch.Generator().manual_seed(3)
    targets = torch.zeros(F64_B, 8, 5, dtype=torch.float64)
    targets[..., 0] = torch.randint(0, 2, (F64_B, 8), generator=g)
    targets[..., 1:3] = torch.rand(F64_B, 8, 2, generator=g,
                                   dtype=torch.float64) * 0.6 + 0.2
    targets[..., 3:] = torch.rand(F64_B, 8, 2, generator=g,
                                  dtype=torch.float64) * 0.3 + 0.1
    mask = torch.zeros(F64_B, 8, dtype=torch.bool)
    mask[:, :5] = True
    return {"rgb": torch.rand(F64_B, F64_IMG, F64_IMG, 3, generator=g,
                              dtype=torch.float64),
            "ir": torch.rand(F64_B, F64_IMG, F64_IMG, 3, generator=g,
                             dtype=torch.float64),
            "targets": targets, "mask": mask}


def f64_spec():
    """The flagship's grammar at "t" width, depth 0.25, one transformer
    layer a fusion level; GPT1_fourier's d_model, which the zoo does not
    scale, scaled as the widths are."""
    spec = two_stream_spec("t", "fourier", nc=2, fusion_layers=1)
    layers = tuple(dataclasses.replace(
        ld, args=(int(ld.args[0] * spec.width_multiple),) + ld.args[1:])
        if ld.name == "GPT1_fourier" else ld for ld in spec.layers)
    return dataclasses.replace(spec, layers=layers, depth_multiple=0.25)


def f64_state(mesh=None):
    """The seeded f64 ``f64_spec`` model (dropout off: one process draws
    its masks otherwise than a mesh) with the trainer's optimizer and
    schedule, and its train step."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TwoStreamDetector(f64_spec(), aux_mode="reference").double()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    cfg = trainer.TrainConfig(epochs=1, batch_size=F64_B, nbs=F64_B,
                              warmup_floor=1)
    hyp = trainer.load_hyp({"lr0": 1e-3, "warmup_bias_lr": 1e-3})
    sched, loss_hyp = trainer.build_sched_and_loss(cfg, hyp, 1)
    opt, _ = popt.build_optimizer(model, sched, hyp["weight_decay"],
                                  total_batch_size=F64_B, nbs=F64_B)
    step = make_train_step(trainer.anchors_grid(model.spec).double(),
                           loss_hyp, mesh=mesh)
    return init_state(model, opt), step


def f64_step(n_data: int, n_model: int) -> dict:
    """One step of ``f64_state`` on this rank's rows of ``f64_batch`` over
    an ``n_data`` x ``n_model`` mesh; the model's and the EMA's state
    dicts, whole."""
    mesh = make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))
    state, step = f64_state(mesh)
    shard_train_state(state, mesh, tp_min_out=F64_TP_MIN_OUT)
    rows = batch_rows(mesh, F64_B)
    step(state, {k: v[rows] for k, v in f64_batch().items()},
         mesh.split(rows.stop - rows.start, F64_B))
    unshard_train_state(state)
    return {"model": state.model.state_dict(), "ema": state.ema.state_dict()}
