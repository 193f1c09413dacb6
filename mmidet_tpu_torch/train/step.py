"""The train step: forward (with the aux fusion losses) + detection loss +
backward, then the optimizer and the EMA on optimizer steps.

Counterpart of ``mmidet_tpu/train/step.py``; the reference's hot loop body
(train.py:737-804).  One call is one micro-step.  Under ``dtype=
"bfloat16"`` the forward runs in ``torch.autocast`` at bf16; parameters,
gradients, optimizer state and the EMA stay f32.  There is no GradScaler:
bf16 has f32's range, and the JAX step scales no loss either.  The loss is
computed in f32 outside autocast.  The metrics come back as 0-dim tensors
on the model's device: nothing here waits for the card.

``remat`` recomputes the forward's activations in the backward, as the
JAX package wraps its whole train forward in ``jax.checkpoint``:
``"full"`` keeps nothing, ``"dots"`` keeps the outputs of the convolutions
and matrix products (JAX's ``checkpoint_dots``, which saves
``dot_general`` and ``conv_general_dilated``) and recomputes the rest.
The recomputation draws the same dropout masks (the RNG state is
restored), runs under the same autocast, and leaves BatchNorm's running
buffers alone, so that a step updates them once, as JAX's functional
``batch_stats`` are.  One checkpoint spans the whole forward, so the
backward's first use of a saved tensor recomputes every activation at
once: the peak memory of a step stays where it is without remat
(``chip_smoke.py``'s ``remat`` phase), where XLA can interleave the
recomputation with the backward.  So on this port ``remat`` saves no
memory and only costs time (an H100 measured 3.0x the plain micro-step
for "full" and 4.2x for "dots", the same peak); it is kept so that the
JAX package's setting trains alike.

``mesh`` (``parallel.mesh.Mesh``): ``step(state, batch, group)`` runs
this rank's rows of the global batch inside their data group (``group``, a
``parallel.comm.DataGroup``; None: the batch is whole on every rank), so
that BatchNorm's statistics, the dropout masks and the losses are the
global batch's; before each optimizer step the summed gradients are
averaged over the data group (the reference's DDP all-reduce, here on the
optimizer steps only, as DDP's ``no_sync`` does between them).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from mmidet_tpu_torch.losses.detection import LossHyp, compute_loss
from mmidet_tpu_torch.nn.layers import BatchNorm2d
from mmidet_tpu_torch.parallel import comm
from mmidet_tpu_torch.parallel.mesh import average_gradients
from mmidet_tpu_torch.train.ema import ModelEMA
from mmidet_tpu_torch.train.optimizer import GroupedOptimizer


@dataclasses.dataclass
class TrainState:
    """``micro_step`` counts steps (loader batches), ``opt_step``
    optimizer steps; the EMA keeps its own update count."""
    model: nn.Module
    ema: ModelEMA
    optimizer: GroupedOptimizer
    micro_step: int = 0
    opt_step: int = 0


def init_state(model: nn.Module, optimizer: GroupedOptimizer,
               ema_decay: float = 0.9999) -> TrainState:
    return TrainState(model=model, ema=ModelEMA(model, ema_decay),
                      optimizer=optimizer)


# the ops whose outputs remat="dots" keeps
_DOTS = {torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _recompute(model: nn.Module, inner, gen=None, gen_state=None):
    """``inner``, with ``model``'s BatchNorms leaving their running
    buffers alone, and ``gen`` (a data-parallel step's dropout generator)
    back at ``gen_state``, so that the recomputation draws the masks
    again."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = False
    if gen is not None:
        gen.set_state(gen_state)
    try:
        with inner:
            yield
    finally:
        for m in bns:
            m.update_stats = True


def _remat_contexts(model: nn.Module, remat: str, gen=None):
    gen_state = None if gen is None else gen.get_state()

    def contexts():
        fwd, rec = (ckpt.create_selective_checkpoint_contexts(_dots_policy)
                    if remat == "dots" else
                    (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _recompute(model, rec, gen, gen_state)
    return contexts


def make_train_step(anchors: torch.Tensor, hyp: LossHyp = LossHyp(),
                    two_stream: bool = True, dtype: str = "float32",
                    remat: str = "", mesh=None):
    """Build ``step(state, batch) -> metrics``.

    batch: dict with 'rgb' (B, H, W, 3) and 'ir' [two-stream] in [0, 1],
    'targets' (B, T, 5) normalized [cls, x, y, w, h], 'mask' (B, T) bool,
    all on the model's device.  The optimizer steps, and the EMA advances,
    every ``state.optimizer.accumulate`` micro-steps (the reference's
    ``ni % accumulate == 0``, train.py:798-804).  ``remat``: "" (off),
    "dots" or "full"; neither lowers the peak memory here (see the module
    docstring)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype {dtype!r}: 'float32' or 'bfloat16'")
    if remat not in ("", "dots", "full"):
        raise ValueError(f"remat {remat!r}: '', 'dots' or 'full'")

    def forward(model, rgb, ir):
        with torch.autocast(rgb.device.type, torch.bfloat16,
                            enabled=dtype == "bfloat16"):
            return model(rgb, ir)

    def step(state: TrainState, batch: dict, group=None) -> dict:
        model = state.model.train()
        dev = batch["rgb"].device
        args = (model, batch["rgb"], batch["ir"] if two_stream else None)
        if mesh is not None and group is None:
            group = mesh.whole(batch["rgb"].shape[0])
        with comm.data_group(group):
            if remat:
                out = ckpt.checkpoint(
                    forward, *args, use_reentrant=False,
                    context_fn=_remat_contexts(
                        model, remat, None if group is None else group.gen))
            else:
                out = forward(*args)
            total, metrics = compute_loss(
                out["train_outs"], batch["targets"], batch["mask"],
                anchors.to(dev), hyp, combine_loss=out["aux"].get("combine"),
                group=group)
            total.backward()
        state.micro_step += 1
        if state.micro_step % state.optimizer.accumulate == 0:
            if mesh is not None:
                average_gradients(model, mesh)
            state.optimizer.step(state.opt_step)
            state.opt_step += 1
            state.ema.update(model)
        return {k: v.detach() for k, v in metrics.items()}

    return step
