"""BatchNorm folding for inference deployment.

Counterpart of ``mmidet_tpu/nn/fuse.py:fold_batchnorm``; reference
``fuse_conv_and_bn`` (utils/torch_utils.py:181) and ``Model.fuse``:

  weight' = weight * scale / sqrt(var + eps)       (per output channel)
  bias'   = bn_bias - mean * scale / sqrt(var + eps)

The pairs folded are the ones the JAX package folds: ``conv``/``bn``
(ConvBnAct, and so Focus's inner conv), ``conv2``/``bn2`` and
``conv3``/``bn3`` (CEM).
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
        for conv_name, bn_name in _PAIRS:
            conv = getattr(mod, conv_name, None)
            bn = getattr(mod, bn_name, None)
            if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                _fold(conv, bn)
                setattr(mod, bn_name, None)
    return model
