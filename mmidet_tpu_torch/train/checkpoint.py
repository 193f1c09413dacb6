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

``load_torch_checkpoint`` reads what a user of the reference holds: its
``.pt`` of pickled ``models.yolo.Model`` objects (``model`` and ``ema``,
usually fp16 after ``strip_optimizer``), as well as state dicts and the
port's own checkpoints (JAX ``train/checkpoint.py:212``).
"""

from __future__ import annotations

import os
import pickle
import re
import sys
import types

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


def _stub_reference_imports() -> None:
    """Stand-ins for the reference's optional heavy imports (``thop``,
    ``torchsummary``), which its modules import but a load never calls."""
    for name in ("thop", "torchsummary"):
        if name not in sys.modules:
            stub = types.ModuleType(name)
            stub.profile = lambda *a, **k: (0, 0)
            stub.clever_format = lambda *a, **k: ("0", "0")
            stub.summary = lambda *a, **k: None
            sys.modules[name] = stub


def load_torch_checkpoint(path: str, reference_repo: str | None = None,
                          prefer_ema: bool = True) -> dict[str, torch.Tensor]:
    """The state dict in a ``.pt``, by the reference's names.

    A state dict or a ``{"model": .., "ema": ..}`` dict of them (the
    port's checkpoints) loads with ``weights_only=True``.  Only when that
    load refuses the file, because it pickles modules (the reference's
    checkpoints hold ``models.yolo.Model`` objects), is it loaded again
    with ``weights_only=False``: such a file is a pickle, and loading it
    imports and runs code, the classes of the reference checkout, which
    ``reference_repo`` puts on ``sys.path`` (with stand-ins for ``thop``
    and ``torchsummary``).  Load only files you trust.  The ``ema`` entry
    is taken over ``model`` unless ``prefer_ema`` is False; a module gives
    ``.float().state_dict()``, so an fp16 checkpoint comes back in f32.
    The port's module names are the reference's, so the result goes
    straight into ``cli.val.load_weights``.  JAX
    ``train/checkpoint.py:load_torch_checkpoint``."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # pickled modules: the reference's
        if reference_repo and reference_repo not in sys.path:
            sys.path.insert(0, reference_repo)
        _stub_reference_imports()
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt
    if isinstance(ckpt, dict):
        model = ckpt["ema"] if prefer_ema and ckpt.get("ema") is not None \
            else ckpt.get("model", ckpt)
    sd = model.float().state_dict() if isinstance(model, torch.nn.Module) \
        else model
    if not isinstance(sd, dict) or not all(
            isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path} holds no state dict of tensors")
    return dict(sd)
