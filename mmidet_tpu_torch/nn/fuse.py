"""BatchNorm folding for inference deployment.

Counterpart of ``mmidet_tpu/nn/fuse.py:fold_batchnorm``; reference
``fuse_conv_and_bn`` (utils/torch_utils.py:181) and ``Model.fuse``:

  weight' = weight * scale / sqrt(var + eps)       (per output channel)
  bias'   = bn_bias - mean * scale / sqrt(var + eps)

The pairs folded are the ones the JAX package folds: ``conv``/``bn``
(ConvBnAct, and so Focus's inner conv, DWConv's, GhostConv's, FReLU's),
``conv2``/``bn2`` and ``conv3``/``bn3`` (CEM).  BatchNorms without a
single conv partner (BottleneckCSP's over its concat, MixConv2d's) and
CrossConv's (``keep_bn``; the JAX package names them ``cv1_bn``/``cv2_bn``
and does not pair them) stay, and run on their running statistics in eval
mode.

``sparsity`` and ``prune_variables`` (reference
``utils/torch_utils.py:163-178``) read and prune the conv kernels of a
state dict: its 4-D ``weight`` tensors.
"""

from __future__ import annotations

import torch
from torch import nn

_PAIRS = (("conv", "bn"), ("conv2", "bn2"), ("conv3", "bn3"))


@torch.no_grad()
def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> None:
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    conv.weight.mul_(scale.view(-1, 1, 1, 1))
    bias = bn.bias - bn.running_mean * scale
    if conv.bias is not None:
        bias = bias + conv.bias * scale
    conv.bias = nn.Parameter(bias)


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every conv/BN pair of ``model`` in place and drop the BNs, so
    that each folded module computes its ``fused=True`` form.  Returns
    ``model``."""
    for mod in model.modules():
        if getattr(mod, "keep_bn", False):
            continue
        for conv_name, bn_name in _PAIRS:
            conv = getattr(mod, conv_name, None)
            bn = getattr(mod, bn_name, None)
            if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                _fold(conv, bn)
                setattr(mod, bn_name, None)
    return model


def _is_conv_kernel(name: str, t: torch.Tensor) -> bool:
    return name.endswith("weight") and t.dim() == 4


def sparsity(state_dict: dict) -> float:
    """Global fraction of zero weights over all conv kernels of
    ``state_dict``.  Ref: utils/torch_utils.py:163-167."""
    zeros = total = 0
    for name, t in state_dict.items():
        if _is_conv_kernel(name, t):
            zeros += int((t == 0).sum())
            total += t.numel()
    return zeros / max(total, 1)


@torch.no_grad()
def prune_variables(state_dict: dict, amount: float = 0.3) -> dict:
    """L1-unstructured pruning: in each conv kernel, zero the weights whose
    |w| lies below the ``amount`` quantile of its |w| (linear
    interpolation, as ``jnp.quantile``).  Ref: utils/torch_utils.py:170-178.
    Returns a new state dict of the same shapes; other entries are
    shared."""
    out = dict(state_dict)
    for name, t in state_dict.items():
        if amount <= 0 or not _is_conv_kernel(name, t):
            continue
        absw = t.abs()
        thresh = torch.quantile(absw.reshape(-1).float(), amount)
        out[name] = torch.where(absw >= thresh.to(t.dtype), t,
                                torch.zeros_like(t))
    return out
