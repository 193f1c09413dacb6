"""s8-storage quantization of the deploy conv stack (the ``--int8`` mode).

Counterpart of ``mmidet_tpu/nn/quant.py``.  A quantized fused
``ConvBnAct`` returns a ``QTensor``: its activation rounded to int8 with
its own calibrated per-tensor scale (x ~= v * s).  Every consumer
dequantizes on entry, so the scale travels with the tensor and no
registry of scales is needed; the convolutions still compute in the
model's dtype.  The scales are calibrated by running the float deploy
model and recording each fused ``ConvBnAct``'s output absmax (forward
hooks, removed after: calibration leaves the state dict as it was).

The scale of a quantized module is its ``out_scale`` buffer, which stays
f32 whatever dtype the model is cast to (``nn.layers.ConvBnAct``), as the
JAX package's ``quant`` collection does.

This is an opt-in deploy mode; weights are untouched, so the error is the
activations' rounding alone.
"""

from __future__ import annotations

import copy
from typing import Iterable, NamedTuple

import torch
from torch import nn


class QTensor(NamedTuple):
    """int8 storage and its per-tensor scale (descale factor)."""
    v: torch.Tensor   # int8
    s: torch.Tensor   # () float32


def quantize(x: torch.Tensor, scale) -> QTensor:
    """``round(x / s)`` in f32, clamped to +-127, as int8.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    return QTensor(q.to(torch.int8), s)


def dequantize(x, dtype: torch.dtype = torch.bfloat16):
    """QTensor -> tensor of ``dtype`` (plain tensors pass through).  The
    scale is cast to ``dtype`` before the product, as the JAX package
    does."""
    if isinstance(x, QTensor):
        return x.v.to(dtype) * x.s.to(dtype)
    return x


def deq_tree(x, dtype: torch.dtype = torch.bfloat16):
    """``dequantize`` through lists and tuples (fusion blocks return
    pairs)."""
    if isinstance(x, QTensor):
        return dequantize(x, dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(deq_tree(v, dtype) for v in x)
    return x


def _fused_convs(model: nn.Module):
    """Every fused ``ConvBnAct`` (BN folded) of ``model`` that the JAX
    package quantizes, by name: those inside quantizable modules only
    (``ConvBnAct``, ``Focus``, ``Bottleneck``, ``C3``, ``SPP``, ``SPPF``,
    ``DWConv`` and the containers that chain them), not the ones of, say,
    ``GhostConv`` or ``C3TR``, which take no ``quant`` there."""
    from mmidet_tpu_torch.nn import layers as L
    quantizable = (L.ConvBnAct, L.Focus, L.Bottleneck, L.C3, L.SPP, L.SPPF,
                   L.DWConv, nn.Sequential, nn.ModuleList)
    out = []
    for name, mod in model.named_modules():
        if not (isinstance(mod, L.ConvBnAct) and mod.bn is None):
            continue
        parts = name.split(".")
        if all(isinstance(model.get_submodule(".".join(parts[:i])),
                          quantizable) for i in range(1, len(parts))):
            out.append((name, mod))
    return out


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, batches: Iterable,
                         clip: float = 1.0) -> dict[str, torch.Tensor]:
    """Run the FLOAT deploy ``model`` over ``batches`` (``(rgb, ir)`` NHWC
    [0, 1] pairs; ir None for a single-stream model) and return the
    ``out_scale`` of every fused ``ConvBnAct``, by its state-dict key
    (``model.2.cv1.out_scale``): ``max(absmax * clip, 1e-4) / 127`` in
    f32, the absmax taken over all batches.

    ``clip`` < 1 trades clipping for finer rounding (the JAX package
    measured 0.9 best on a converged model)."""
    convs = _fused_convs(model)
    if not convs:
        raise ValueError("calibrate_act_scales needs the BN-folded model")
    absmax: dict[str, torch.Tensor] = {}

    def hook(name):
        def record(mod, inp, out):
            m = out.detach().float().abs().amax()
            absmax[name] = m if name not in absmax else \
                torch.maximum(absmax[name], m)
        return record

    hooks = [mod.register_forward_hook(hook(name)) for name, mod in convs]
    was_training = model.training
    model.eval()
    try:
        for rgb, ir in batches:
            model(rgb, ir)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return {f"{name}.out_scale":
            torch.clamp(absmax[name].float().cpu() * clip, min=1e-4) / 127.0
            for name, _ in convs}


def set_quant(model: nn.Module, scales: dict[str, torch.Tensor]) -> nn.Module:
    """Turn ``model``'s quant flags on in place, each fused ``ConvBnAct``
    with its scale from ``scales`` (``calibrate_act_scales``'s keys).
    Returns ``model``."""
    for name, mod in _fused_convs(model):
        key = f"{name}.out_scale"
        if key not in scales:
            raise KeyError(f"no calibrated scale for {key}")
        mod.set_quant(scales[key])
    return model


def make_quant_deploy(model: nn.Module, calib_batches: Iterable,
                      clip: float = 1.0) -> nn.Module:
    """One call from a float model to its s8-storage deploy twin: a copy
    of ``model``, BN folded if it is not, calibrated on ``calib_batches``
    (see ``calibrate_act_scales``) and quantized.  ``model`` itself is
    left as it is; a model that is quantized already is calibrated anew as
    its float twin.  The entry behind the val, detect and serve CLIs'
    ``--int8``."""
    from mmidet_tpu_torch.nn.fuse import fold_batchnorm
    q_model = fold_batchnorm(copy.deepcopy(model)).eval()
    for _, mod in _fused_convs(q_model):
        mod.quant = False
    scales = calibrate_act_scales(q_model, calib_batches, clip=clip)
    return set_quant(q_model, scales)
