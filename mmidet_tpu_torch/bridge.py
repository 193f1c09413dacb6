"""Load JAX-package variables into the port's modules.

``from_jax_variables(model, variables)`` takes the flax variables as nested
dicts of numpy arrays (``{"params": ..., "batch_stats": ...}``) and copies
every leaf into the port module's state dict.  The port's modules carry the
reference torch names, so the key of each leaf is what the JAX package's
checkpoint converter computes (``mmidet_tpu/train/checkpoint.py:84-169``,
``_torch_key``/``_transform``; copied here, reversed):

  * conv kernels HWIO -> OIHW; Dense kernels (in, out) -> (out, in);
  * ``sobel_factor`` (out,) -> (out, 1, 1, 1);
  * the ``trans`` and ``pattern`` scopes of the fusion blocks are flat in
    the reference (``pattern/conv1/kernel`` -> ``conv1.weight``);
  * Focus's ``conv_kernel_s2d`` -> ``conv.conv.weight`` (and its folded
    ``conv_bias`` -> ``conv.conv.bias``);
  * BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``, copied as stored.

Every leaf must land on exactly one key of matching shape, and every key
(but BN's ``num_batches_tracked``) must receive one; anything else raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LINEAR_SCOPES = ("que_proj", "key_proj", "val_proj", "out_proj", "mlp_fc1",
                  "mlp_fc2")


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def torch_key(path: tuple[str, ...]) -> tuple[str, str]:
    """flax variable path -> (port state-dict key, transform kind)."""
    segs = list(path)
    head = segs.pop(0)
    m = re.match(r"l(\d+)_(.+)", head)
    if m:
        prefix = f"model.{m.group(1)}"
    elif head == "enhance":
        prefix = "Enhance"
    else:
        raise KeyError(f"unmapped top-level {head}")
    out: list[str] = []
    kind = "raw"
    for i, s in enumerate(segs):
        if i == len(segs) - 1:
            if s == "kernel":
                kind = "linear" if any(p in _LINEAR_SCOPES
                                       for p in segs[:i]) else "conv"
                out.append("weight")
            elif s == "scale":
                out.append("weight")
            elif s == "mean":
                out.append("running_mean")
            elif s == "var":
                out.append("running_var")
            elif s == "conv_kernel_s2d":
                kind = "conv"
                out.append("conv.conv.weight")
            elif s == "conv_bias":  # Focus after BN folding
                out.append("conv.conv.bias")
            elif s == "sobel_factor":
                kind = "factor"
                out.append("sobel_factor")
            else:
                out.append(s)
        elif re.fullmatch(r"m\d+", s):        # C3 repeats / Detect convs
            out.append("m." + s[1:])
        elif re.fullmatch(r"block\d+", s):    # token transformer blocks
            out.append("trans_blocks." + s[len("block"):])
        elif s in ("trans", "pattern"):       # flat in the reference
            pass
        elif s == "mlp_fc1":
            out.append("mlp.0")
        elif s == "mlp_fc2":
            out.append("mlp.2")
        elif s == "conv_bn":                  # Focus's BN
            out.append("conv.bn")
        else:
            out.append(s)
    return prefix + "." + ".".join(out), kind


def to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
    if kind == "linear":
        return np.transpose(arr, (1, 0))
    if kind == "factor":
        return arr.reshape(-1, 1, 1, 1)
    return arr


@torch.no_grad()
def from_jax_variables(model: torch.nn.Module, variables: dict) -> dict:
    """Copy ``variables`` into ``model`` in place.  Returns the mapping
    {port key: flax path} it used."""
    sd = model.state_dict()
    used: dict[str, tuple] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            key, kind = torch_key(path)
            if key not in sd:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {key}: "
                               "no such key in the port module")
            if key in used:
                raise KeyError(f"{key} receives both {used[key]} and {path}")
            val = to_torch_layout(arr, kind)
            if tuple(val.shape) != tuple(sd[key].shape):
                raise ValueError(f"shape mismatch {key}: jax {val.shape} vs "
                                 f"port {tuple(sd[key].shape)}")
            sd[key].copy_(torch.tensor(val))
            used[key] = (collection,) + path
    left = [k for k in sd if k not in used
            and not k.endswith("num_batches_tracked")]
    if left:
        raise KeyError(f"{len(left)} port keys received no variable, e.g. "
                       f"{left[:5]}")
    return used
