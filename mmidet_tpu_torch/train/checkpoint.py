"""Checkpointing: the train state as ``torch.save`` dicts, rolling
retention, and the deploy strip.

Counterpart of the orbax save/restore of ``mmidet_tpu/train/
checkpoint.py``; reference ``train.py:881-899`` (model + EMA + optimizer
per epoch) and ``strip_optimizer`` (general.py:584-598).  A checkpoint is
``<dir>/epoch<N>.pt`` holding ``{"model": state dict, "ema": state dict,
"optimizer": ..., "step", "micro_step", "ema_updates", "epoch",
"best_fitness", "fitness"}``, and ``"grads"`` (parameter name -> the
gradient sum so far) when ``micro_step`` stops between two optimizer
steps, as the JAX package's ``MultiSteps`` state carries its partial sum
in ``opt_state``; the newest ``keep`` files stay (3 for
``ckpt/``, 1 for ``ckpt_best/``, as the JAX package keeps).  The port's
``cli/val.py`` reads the ``ema`` entry of such a file (``--weights
<run>/ckpt_best/epoch<N>.pt``).  The JAX package's orbax checkpoints are
its own format and are not read here.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"epoch(\d+)\.pt$")


def checkpoints(ckpt_dir: str) -> list[str]:
    """The checkpoint files under ``ckpt_dir``, oldest epoch first."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = [(int(m.group(1)), f) for f in os.listdir(ckpt_dir)
             if (m := _NAME.fullmatch(f))]
    return [os.path.join(ckpt_dir, f) for _, f in sorted(found)]


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    metadata: dict | None = None, keep: int = 3) -> str:
    """Write ``epoch<epoch>.pt`` (through a temporary file, then a rename)
    and drop all but the newest ``keep``.  Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch{epoch}.pt")
    payload = {"model": state.model.state_dict(),
               "ema": state.ema.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": state.opt_step, "micro_step": state.micro_step,
               "ema_updates": state.ema.updates, "epoch": epoch,
               **(metadata or {})}
    if state.micro_step % state.optimizer.accumulate:
        payload["grads"] = {n: p.grad for n, p in
                            state.model.named_parameters()
                            if p.grad is not None}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in checkpoints(ckpt_dir)[:-keep]:
        os.remove(old)
    return path


def restore_checkpoint(ckpt_dir: str, state):
    """Load the newest checkpoint under ``ckpt_dir`` into ``state`` (model,
    EMA, optimizer, counts, a partial gradient sum).  Returns (state, step,
    metadata); raises FileNotFoundError when there is none."""
    found = checkpoints(ckpt_dir)
    if not found:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ck = torch.load(found[-1], map_location="cpu", weights_only=True)
    state.model.load_state_dict(ck["model"])
    state.ema.module.load_state_dict(ck["ema"])
    state.ema.updates = int(ck["ema_updates"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.opt_step, state.micro_step = int(ck["step"]), int(ck["micro_step"])
    grads = ck.get("grads", {})
    for n, p in state.model.named_parameters():
        p.grad = grads[n].to(p.device) if n in grads else None
    meta = {k: ck[k] for k in ("epoch", "best_fitness", "fitness")
            if k in ck}
    return state, state.opt_step, meta


def strip_for_deploy(state) -> dict:
    """The EMA's state dict only (the reference's strip_optimizer: model
    <- ema, training state dropped)."""
    return {k: v.detach().clone() for k, v in state.ema.state_dict().items()}
