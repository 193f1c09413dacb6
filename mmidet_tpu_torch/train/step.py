"""The train step: forward (with the aux fusion losses) + detection loss +
backward, then the optimizer and the EMA on optimizer steps.

Counterpart of ``mmidet_tpu/train/step.py``; the reference's hot loop body
(train.py:737-804).  One call is one micro-step.  Under ``dtype=
"bfloat16"`` the forward runs in ``torch.autocast`` at bf16; parameters,
gradients, optimizer state and the EMA stay f32.  There is no GradScaler:
bf16 has f32's range, and the JAX step scales no loss either.  The loss is
computed in f32 outside autocast.  The metrics come back as 0-dim tensors
on the model's device: nothing here waits for the card.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mmidet_tpu_torch.losses.detection import LossHyp, compute_loss
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


def make_train_step(anchors: torch.Tensor, hyp: LossHyp = LossHyp(),
                    two_stream: bool = True, dtype: str = "float32"):
    """Build ``step(state, batch) -> metrics``.

    batch: dict with 'rgb' (B, H, W, 3) and 'ir' [two-stream] in [0, 1],
    'targets' (B, T, 5) normalized [cls, x, y, w, h], 'mask' (B, T) bool,
    all on the model's device.  The optimizer steps, and the EMA advances,
    every ``state.optimizer.accumulate`` micro-steps (the reference's
    ``ni % accumulate == 0``, train.py:798-804)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype {dtype!r}: 'float32' or 'bfloat16'")

    def step(state: TrainState, batch: dict) -> dict:
        model = state.model.train()
        dev = batch["rgb"].device
        with torch.autocast(dev.type, torch.bfloat16,
                            enabled=dtype == "bfloat16"):
            out = model(batch["rgb"], batch["ir"] if two_stream else None)
        total, metrics = compute_loss(
            out["train_outs"], batch["targets"], batch["mask"],
            anchors.to(dev), hyp, combine_loss=out["aux"].get("combine"))
        total.backward()
        state.micro_step += 1
        if state.micro_step % state.optimizer.accumulate == 0:
            state.optimizer.step(state.opt_step)
            state.opt_step += 1
            state.ema.update(model)
        return {k: v.detach() for k, v in metrics.items()}

    return step
