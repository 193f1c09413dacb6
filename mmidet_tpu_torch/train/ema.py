"""Exponential moving average of the model state.

Counterpart of ``mmidet_tpu/train/ema.py``; reference ``ModelEMA``
(utils/torch_utils.py:269-303): the decay ramps as
``d = decay * (1 - exp(-updates / 2000))`` and the average covers the
whole state dict, parameters *and* BatchNorm running statistics (every
floating-point entry; ``num_batches_tracked`` is copied).  The update is
two fused ``torch._foreach_*`` calls under ``torch.no_grad()``, on the
card when the model is there.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn


class ModelEMA:
    """``module``: the averaged copy (eval mode, no gradients)."""

    def __init__(self, model: nn.Module, decay: float = 0.9999,
                 updates: int = 0):
        self.module = copy.deepcopy(model).eval()
        for p in self.module.parameters():
            p.requires_grad_(False)
        self.decay = decay
        self.updates = updates
        self._paired = (None,)

    def _pairs(self, model: nn.Module):
        """(EMA floats, model floats, other (EMA, model) pairs): views of
        both state dicts, made once per model (the tensors are updated in
        place, so the views stay current)."""
        if self._paired[0] is not model:
            own, src = self.module.state_dict(), model.state_dict()
            floats = [k for k, v in own.items() if v.is_floating_point()]
            self._paired = (model, [own[k] for k in floats],
                            [src[k] for k in floats],
                            [(own[k], src[k]) for k in own
                             if k not in floats])
        return self._paired[1:]

    def decay_at(self, updates: int) -> float:
        """d after ``updates`` updates, in f32 as the JAX package."""
        d = np.float32(self.decay) * (np.float32(1) - np.exp(
            -np.float32(updates) / np.float32(2000)))
        return float(d)

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.updates += 1
        d = self.decay_at(self.updates)
        ema, cur, rest = self._pairs(model)
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, cur, alpha=1.0 - d)
        for e, c in rest:
            e.copy_(c)

    def state_dict(self) -> dict:
        return self.module.state_dict()
