"""LR / momentum schedules: YOLOv5 warmup + one-cycle cosine as per-step
functions of the optimizer-step count.

Counterpart of ``mmidet_tpu/train/schedule.py``; reference ``one_cycle``
(utils/general.py), the LambdaLR wiring (train.py:593-597) and the in-loop
warmup interpolation (train.py:765-773):

  * ``lf(epoch) = (1 + cos(pi * epoch / epochs)) / 2 * (1 - lrf) + lrf``
  * warmup over ``nw = max(round(warmup_epochs * nb), warmup_floor)``
    steps: lr linearly from 0 (bias group: ``warmup_bias_lr``) to
    ``lr0 * lf(epoch)``, momentum from ``warmup_momentum`` to ``momentum``.

The cosine steps once per epoch (``steps_per_epoch``), a staircase, as the
reference's LambdaLR.  The functions return Python floats, computed in f32
as the JAX package's, so that setting a parameter group's ``lr`` never
waits for the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    lr0: float = 0.01
    lrf: float = 0.2
    momentum: float = 0.937
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    epochs: int = 100
    steps_per_epoch: int = 100
    linear_lr: bool = False
    # the reference floors warmup at 1000 iterations (train.py:758), which
    # can swallow a whole run on a small dataset
    warmup_floor: int = 1000

    @property
    def warmup_steps(self) -> int:
        return max(round(self.warmup_epochs * self.steps_per_epoch),
                   self.warmup_floor, 1)


_f32 = np.float32


def _lf(cfg: ScheduleConfig, epoch):
    if cfg.linear_lr:
        return (1 - epoch / _f32(cfg.epochs - 1)) * _f32(1.0 - cfg.lrf) + \
            _f32(cfg.lrf)
    return (1 + np.cos(epoch * _f32(np.pi) / _f32(cfg.epochs))) / 2 * \
        _f32(1 - cfg.lrf) + _f32(cfg.lrf)


def lr_schedule(cfg: ScheduleConfig, warmup_start: float = 0.0):
    """Per-step lr: warmup from ``warmup_start`` into the epoch-staircase
    cosine."""
    def fn(step) -> float:
        step = _f32(step)
        epoch = np.floor(step / _f32(cfg.steps_per_epoch))
        target = _f32(cfg.lr0) * _lf(cfg, epoch)
        frac = np.clip(step / _f32(cfg.warmup_steps), _f32(0), _f32(1))
        warm = _f32(warmup_start) + frac * (target - _f32(warmup_start))
        return float(warm if step < cfg.warmup_steps else target)
    return fn


def momentum_schedule(cfg: ScheduleConfig):
    def fn(step) -> float:
        frac = np.clip(_f32(step) / _f32(cfg.warmup_steps), _f32(0),
                       _f32(1))
        return float(_f32(cfg.warmup_momentum)
                     + frac * _f32(cfg.momentum - cfg.warmup_momentum))
    return fn
