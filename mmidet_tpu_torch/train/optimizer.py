"""Optimizer: SGD (Nesterov) or Adam over YOLOv5's parameter groups, with
per-group warmup schedules and gradient accumulation.

Counterpart of ``mmidet_tpu/train/optimizer.py``; reference
``train.py:566-597``.  One ``torch.optim`` parameter group per label:
  * ``weight``: conv/linear weights and LayerNorm scales, with weight decay
    scaled ``total_batch * accumulate / nbs`` (train.py:569);
  * ``bias``: every bias, no decay, warmup lr from ``warmup_bias_lr``;
  * ``bn``: the rest, no decay;
  * ``frozen``: kept out of the optimizer (``requires_grad`` off).

The labels are the JAX package's under ``bridge.py``'s name map, quirks
included: its BatchNorm scopes are named ``bn``/``conv_bn``/``bn2``/``bn3``
while its ``label_params`` exempts only scopes named ``BatchNorm*``, so BN
scales land in the decayed ``weight`` group; and Focus's kernel, stored as
``conv_kernel_s2d``, is neither ``kernel`` nor ``scale`` and lands in
``bn``.  ``pos_emb`` and ``sobel_factor`` (which the reference never
trains, train.py:572-579) go to ``bn`` under ``groups="fixed"`` and to
``frozen`` under ``"reference"``.

Gradients SUM over ``accumulate`` micro-steps (the reference's repeated
``loss.backward()``, train.py:796; optax ``MultiSteps(use_grad_mean=
False)`` in the JAX package): ``.backward()`` sums into ``.grad``, and
``GroupedOptimizer.step`` runs every ``accumulate`` micro-steps, setting
each group's lr and momentum from the schedules at the optimizer-step count
first, then zeroing the gradients.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mmidet_tpu_torch.nn.layers import Focus
from mmidet_tpu_torch.train.schedule import (ScheduleConfig, lr_schedule,
                                             momentum_schedule)

_UNGROUPED = ("pos_emb", "sobel_factor")  # the reference leaves these out


def _leaf_kinds(model: nn.Module) -> dict[str, str]:
    """Parameter name -> the kind of its JAX leaf: 'kernel' (conv and
    linear weights), 'scale' (BatchNorm and LayerNorm weights), 'bias' or
    'other'."""
    kinds, focus = {}, []
    for mname, mod in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(mod, Focus):  # the JAX package's conv_kernel_s2d
            focus.append(prefix + "conv.conv.weight")
        for pname, _ in mod.named_parameters(recurse=False):
            kind = "other"
            if pname == "bias":
                kind = "bias"
            elif pname == "weight" and isinstance(mod, (nn.Conv2d,
                                                         nn.Linear)):
                kind = "kernel"
            elif pname == "weight" and isinstance(mod, (nn.BatchNorm2d,
                                                         nn.LayerNorm)):
                kind = "scale"
            kinds[prefix + pname] = kind
    kinds.update((name, "other") for name in focus)
    return kinds


def label_params(model: nn.Module, groups: str = "fixed",
                 freeze: tuple = ()) -> dict[str, str]:
    """{parameter name: 'bn' | 'weight' | 'bias' | 'frozen'}, the JAX
    package's labels (see the module docstring).  ``freeze``: substrings
    matched against the parameter name (the reference's ``model.N.``
    prefixes, train.py:556-563)."""
    labels = {}
    for name, kind in _leaf_kinds(model).items():
        leaf = name.rsplit(".", 1)[-1]
        if freeze and any(f in name for f in freeze):
            labels[name] = "frozen"
        elif leaf in _UNGROUPED:
            labels[name] = "frozen" if groups == "reference" else "bn"
        elif kind == "bias":
            labels[name] = "bias"
        elif kind in ("scale", "kernel"):
            labels[name] = "weight"
        else:
            labels[name] = "bn"
    return labels


def _opt_step_sched(sched: ScheduleConfig, accumulate: int
                    ) -> ScheduleConfig:
    """A micro-step ScheduleConfig in OPTIMIZER-step units: the schedules
    advance once per ``accumulate`` micro-batches, while steps_per_epoch
    and warmup_floor count loader iterations (train.py:758,765)."""
    if accumulate <= 1:
        return sched
    return dataclasses.replace(
        sched,
        steps_per_epoch=max(round(sched.steps_per_epoch / accumulate), 1),
        warmup_floor=max(round(sched.warmup_floor / accumulate), 1))


class GroupedOptimizer:
    """A ``torch.optim`` optimizer with one parameter group per label
    (``group["name"]``) and the schedules that set each group's lr (and,
    for SGD, momentum) at every optimizer step."""

    def __init__(self, opt: torch.optim.Optimizer, labels: dict,
                 sched: ScheduleConfig, accumulate: int):
        self.opt, self.labels, self.accumulate = opt, labels, accumulate
        s = _opt_step_sched(sched, accumulate)
        self.lr_fns = {"bn": lr_schedule(s), "weight": lr_schedule(s),
                       "bias": lr_schedule(s, warmup_start=s.warmup_bias_lr)}
        self.momentum_fn = momentum_schedule(s) \
            if isinstance(opt, torch.optim.SGD) else None

    def step(self, opt_step: int) -> None:
        """One optimizer step at schedule step ``opt_step`` on the summed
        gradients, then the gradients are zeroed."""
        for g in self.opt.param_groups:
            g["lr"] = self.lr_fns[g["name"]](opt_step)
            if self.momentum_fn is not None:
                g["momentum"] = self.momentum_fn(opt_step)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd)


def _groups(model: nn.Module, labels: dict, wd: float) -> list[dict]:
    params = dict(model.named_parameters())
    out = []
    for name in ("bn", "weight", "bias"):
        ps = [params[k] for k, v in labels.items() if v == name]
        if ps:
            out.append({"params": ps, "name": name,
                        "weight_decay": wd if name == "weight" else 0.0})
    for k, v in labels.items():
        if v == "frozen":
            params[k].requires_grad_(False)
    return out


def build_optimizer(model: nn.Module, sched: ScheduleConfig,
                    weight_decay: float, total_batch_size: int,
                    nbs: int = 64, groups: str = "fixed",
                    accumulate: int | None = None, freeze: tuple = ()):
    """SGD (Nesterov) over the groups.  Returns (GroupedOptimizer, labels);
    ``weight_decay`` is scaled as the reference (train.py:567-569)."""
    if accumulate is None:
        accumulate = max(round(nbs / total_batch_size), 1)
    wd = weight_decay * total_batch_size * accumulate / nbs
    labels = label_params(model, groups, freeze)
    opt = torch.optim.SGD(_groups(model, labels, wd), lr=0.0,
                          momentum=sched.warmup_momentum, nesterov=True)
    return GroupedOptimizer(opt, labels, sched, accumulate), labels


def build_adam(model: nn.Module, sched: ScheduleConfig, weight_decay: float,
               total_batch_size: int, nbs: int = 64, groups: str = "fixed",
               freeze: tuple = ()):
    """The reference's --adam path (train.py:581-582): Adam with beta1 =
    momentum, beta2 = 0.999; the same groups, decay and schedules (lr
    only)."""
    accumulate = max(round(nbs / total_batch_size), 1)
    wd = weight_decay * total_batch_size * accumulate / nbs
    labels = label_params(model, groups, freeze)
    opt = torch.optim.Adam(_groups(model, labels, wd), lr=0.0,
                           betas=(sched.momentum, 0.999))
    return GroupedOptimizer(opt, labels, sched, accumulate), labels
