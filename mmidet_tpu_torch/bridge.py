"""Load JAX-package variables into the port's modules.

``from_jax_variables(model, variables)`` takes the flax variables as nested
dicts of numpy arrays (``{"params": ..., "batch_stats": ...}``) and copies
every leaf into the port module's state dict.  The port's modules carry the
reference torch names, so the key of each leaf is what the JAX package's
checkpoint converter computes (``mmidet_tpu/train/checkpoint.py:84-169``,
``_torch_key``/``_transform``; copied here, reversed):

  * conv kernels HWIO -> OIHW; Dense kernels (in, out) -> (out, in) (the
    kernels under ``_LINEAR_SCOPES``, as the JAX package's converter reads
    them);
  * flax ``MultiHeadDotProductAttention`` (C3TR's ``ma``): the
    ``query``/``key``/``value`` kernels (c, heads, head_dim) and the
    ``out`` kernel (heads, head_dim, c) -> ``nn.Linear`` weights
    (c, heads * head_dim); their biases flattened;
  * repeated rows: ``l{i}_{name}`` and ``l{i}_{name}_r{r}`` ->
    ``model.{i}.0`` and ``model.{i}.{r}`` (the reference's
    ``nn.Sequential``); the C3TR block's ``tr{j}`` -> ``tr.{j}`` and a
    Mamba stack's ``layer{j}`` -> ``layers.{j}``; CrossConv's
    ``cv1_conv``/``cv1_bn`` -> ``cv1.conv``/``cv1.bn``;
  * Mamba's ``conv1d_kernel``, ``conv1d_bias``, ``A_log``, ``D`` and
    RMSNorm ``weight`` leaves are copied as stored;
  * ``sobel_factor`` (out,) -> (out, 1, 1, 1);
  * the ``trans`` and ``pattern`` scopes of the fusion blocks are flat in
    the reference (``pattern/conv1/kernel`` -> ``conv1.weight``);
  * Focus's ``conv_kernel_s2d`` -> ``conv.conv.weight`` (and its folded
    ``conv_bias`` -> ``conv.conv.bias``);
  * BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``, copied as stored;
  * the ``quant`` collection's ``out_scale`` (the s8-storage deploy form)
    -> the quantized ``ConvBnAct``'s ``out_scale`` buffer; JAX's ``Focus``
    keeps its scale on its own scope, the port's on the ``ConvBnAct`` it
    wraps (``l0_Focus/out_scale`` -> ``model.0.conv.out_scale``).

Every leaf must land on exactly one key of matching shape, and every key
(but BN's ``num_batches_tracked``) must receive one; anything else raises.

``from_flax_aux`` does the same for the modules of
``nn/aux_experimental.py``, whose port carries the flax scope names.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LINEAR_SCOPES = ("que_proj", "key_proj", "val_proj", "out_proj", "mlp_fc1",
                  "mlp_fc2", "linear", "q", "k", "v", "fc1", "fc2",
                  "in_proj", "x_proj", "dt_proj")
_MHA = ("query", "key", "value", "out")


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def repeated_rows(variables: dict) -> frozenset:
    """The layer indices whose JAX scopes repeat (``l{i}_{name}_r{r}``)."""
    return frozenset(
        int(m.group(1)) for col in variables.values() for head in col
        if (m := re.fullmatch(r"l(\d+)_.+_r\d+", head)))


def torch_key(path: tuple[str, ...],
              repeated: frozenset = frozenset()) -> tuple[str, str]:
    """flax variable path -> (port state-dict key, transform kind).
    ``repeated``: the rows of ``repeated_rows``, whose first copy sits at
    ``model.{i}.0``."""
    segs = list(path)
    head = segs.pop(0)
    m = re.match(r"l(\d+)_(.+)", head)
    if m:
        prefix = f"model.{m.group(1)}"
        r = re.search(r"_r(\d+)$", head)
        if r or int(m.group(1)) in repeated:
            prefix += "." + (r.group(1) if r else "0")
    elif head == "enhance":
        prefix = "Enhance"
    else:
        raise KeyError(f"unmapped top-level {head}")
    out: list[str] = []
    kind = "raw"
    mha = len(segs) >= 3 and segs[-3] == "ma" and segs[-2] in _MHA
    for i, s in enumerate(segs):
        if i == len(segs) - 1:
            if s == "kernel":
                if mha:
                    kind = "mha_out" if segs[-2] == "out" else "mha_in"
                else:
                    kind = "linear" if any(p in _LINEAR_SCOPES
                                           for p in segs[:i]) else "conv"
                out.append("weight")
            elif s == "bias" and mha:
                kind = "flat"
                out.append("bias")
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
            elif s == "out_scale" and i == 0 and head.endswith("_Focus"):
                out.append("conv.out_scale")
            else:
                out.append(s)
        elif re.fullmatch(r"m\d+", s):        # C3 repeats / Detect convs
            out.append("m." + s[1:])
        elif re.fullmatch(r"block\d+", s):    # token transformer blocks
            out.append("trans_blocks." + s[len("block"):])
        elif re.fullmatch(r"tr\d+", s):       # C3TR's transformer layers
            out.append("tr." + s[2:])
        elif re.fullmatch(r"layer\d+", s):    # Mamba stacks
            out.append("layers." + s[len("layer"):])
        elif re.fullmatch(r"cv\d+_(conv|bn)", s):  # CrossConv
            out.append(s.replace("_", "."))
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
    if kind in ("conv", "linear"):
        # by rank: MetaAconC's fc1/fc2 are convs under a Dense's scope name
        if arr.ndim == 4:
            return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        return np.transpose(arr, (1, 0))
    if kind == "mha_in":    # (c, heads, head_dim) -> (heads * head_dim, c)
        return arr.reshape(arr.shape[0], -1).T
    if kind == "mha_out":   # (heads, head_dim, c) -> (c, heads * head_dim)
        return arr.reshape(-1, arr.shape[-1]).T
    if kind == "flat":
        return arr.reshape(-1)
    if kind == "factor":
        return arr.reshape(-1, 1, 1, 1)
    return arr


@torch.no_grad()
def from_jax_variables(model: torch.nn.Module, variables: dict) -> dict:
    """Copy ``variables`` into ``model`` in place.  Returns the mapping
    {port key: flax path} it used."""
    sd = model.state_dict()
    used: dict[str, tuple] = {}
    repeated = repeated_rows(variables)
    for collection in ("params", "batch_stats", "quant"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            key, kind = torch_key(path, repeated)
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


@torch.no_grad()
def from_flax_aux(module: torch.nn.Module, variables: dict) -> list[str]:
    """Copy the flax variables of a ``nn/aux_experimental.py`` module (the
    VAE, a feature extractor with its BN statistics, the decoder) into its
    port, whose submodules carry the flax scope names.  Kernels: Conv
    HWIO -> OIHW; ConvTranspose HWIO -> (in, out, kh, kw), flipped in
    space (flax does not flip, torch's transposed convolution does); Dense
    (in, out) -> (out, in), and the VAE's three linear layers' sides that
    meet the (h/4, w/4, 64) maps from NHWC to NCHW order.  Every port
    entry but BN's ``num_batches_tracked`` must receive one leaf.  Returns
    the port keys written."""
    from mmidet_tpu_torch.nn.aux_experimental import VAE, FlaxConvTranspose
    sd = module.state_dict()
    grid = getattr(module, "grid", None) if isinstance(module, VAE) else None
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var", "kernel": "weight"}
    written = []
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            scope, leaf = ".".join(path[:-1]), path[-1]
            sub = module.get_submodule(scope)
            if leaf == "kernel" and isinstance(sub, FlaxConvTranspose):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif grid is not None and scope in ("fc_mu", "fc_logvar",
                                                "dec_fc"):
                h, w = grid
                if leaf == "kernel" and scope != "dec_fc":
                    arr = arr.reshape(h, w, 64, -1).transpose(
                        2, 0, 1, 3).reshape(h * w * 64, -1)
                elif scope == "dec_fc":
                    lead = arr.shape[:-1]
                    arr = arr.reshape(*lead, h, w, 64)
                    arr = np.moveaxis(arr, -1, -3).reshape(*lead, -1)
            if leaf == "kernel" and arr.ndim == 2:
                arr = arr.T
            key = f"{scope}.{names[leaf]}"
            if key not in sd or tuple(sd[key].shape) != arr.shape:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {key}: "
                               f"no port entry of shape {arr.shape}")
            sd[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            written.append(key)
    left = [k for k in sd if k not in written
            and not k.endswith("num_batches_tracked")]
    if left:
        raise KeyError(f"port entries received no variable: {left}")
    return written
