"""The two-stream (visible + infrared) detection model, in PyTorch.

Counterpart of ``mmidet_tpu/models/detector.py:TwoStreamDetector``;
reference ``Model`` / ``forward_once`` (``models/yolo_test.py:77-276``).
The layer graph is the ``ModelSpec``, executed as a DAG: the ``-4`` route
feeds the IR image to the second stream.  ``model.train()`` is the JAX
package's ``train=True``: BatchNorm on batch statistics, dropout in the
fusion transformers, no decode.

The Info-Guided auxiliary losses come back in ``out["aux"]``, as the JAX
package computes them (``detector.py:185-262``): ``aux_mode="reference"``
is the reference's effective loss surface (its ``Combine_loss`` is
overwritten with the SSIM term, ``yolo_test.py:266``), ``"full"`` the
a1..a4 weighted sum the code intended, ``"off"`` none (inference):
  * ``contrastive`` around GPT1_fourier's inputs only;
  * ``pattern``, the separation loss of GPT1 and GPT1_fourier;
  * ``ssim`` (``fusing_loss``) on GPT1_fourier's inputs and ``(r + i) / 2``;
  * ``entropy`` in ``"full"`` mode only;
  * ``combine``: ``ssim`` in ``"reference"`` mode, the ``AUX_WEIGHTS`` sum
    in ``"full"``.

Modules sit at ``model.{i}`` (parameter-free layers hold an
``nn.Identity``) and the CEM at ``Enhance``, the reference's state-dict
names.  A row repeated ``n > 1`` times outside the C3 family (hub
``yolov3.yaml``'s Bottleneck rows) chains ``n`` copies of its module, the
reference's ``nn.Sequential`` at ``model.{i}.{r}``; the JAX package names
the copies ``l{i}_{name}``, ``l{i}_{name}_r1``, ...

Every row the JAX package's detector takes is built: the conv-stack rows
of ``nn.layers`` (``_ROWS``), the fusion blocks (GPT, GPT1, GPT1_fourier
and ``MambaFusion``, whose two outputs go through the ``Add2`` rows
unmerged), ``Detect``, and the parameter-free ``Concat``, ``Add``,
``Add2``, ``Upsample`` (nearest or bilinear), ``nn.MaxPool2d`` (padded
with -inf, as the JAX package's ``reduce_window``), ``nn.ZeroPad2d``
(``(left, right, top, bottom)``), ``Contract`` and ``Expand``.

Single-stream models (reference ``models/yolo.py``) run through the same
executor: a spec without ``-4`` refs, ``use_cem=False`` and ``ir=None``.

``quant=True`` is the s8-storage deploy form (``mmidet_tpu_torch.nn.quant``,
JAX ``detector.py:53-58``): the conv-stack rows (``_QUANT_CAPABLE``) pass
int8 ``QTensor``s between them, and every other row (the fusion blocks, so
the kernels still read floats, ``Concat``, ``Add``, ``Add2``, ``Upsample``,
``Detect``) dequantizes its inputs to the model's dtype on entry.

Public layout is the JAX package's: images NHWC ``(B, H, W, 3)`` in [0, 1];
``pred`` ``(B, N, 5+nc)``; ``train_outs`` per level ``(B, na, ny, nx, no)``.
Inside, tensors are NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.losses import fusion as fusion_losses
from mmidet_tpu_torch.models.detect_head import Detect
from mmidet_tpu_torch.models.spec import SECOND_INPUT, ModelSpec, resolve
from mmidet_tpu_torch.nn import layers as L
from mmidet_tpu_torch.nn.cem import ContourEnhance
from mmidet_tpu_torch.nn.fusion import (CrossModalTransformer,
                                        FourierPatternFusion, PatternFusion)
from mmidet_tpu_torch.nn.mamba import MambaFusion
from mmidet_tpu_torch.nn.quant import deq_tree
from mmidet_tpu_torch.nn.resize import bilinear_resize, nearest_upsample
from mmidet_tpu_torch.parallel import comm

AUX_WEIGHTS = (0.1, 1.0, 0.06, 0.03)  # a1..a4, yolo_test.py:170-178
_PARAMETER_FREE = {"Concat", "Add", "Add2", "Upsample", "nn.Upsample",
                   "nn.MaxPool2d", "nn.ZeroPad2d", "Contract", "Expand"}
_FUSION = {"GPT": CrossModalTransformer, "GPT1": PatternFusion,
           "GPT1_fourier": FourierPatternFusion}
# rows built as ``cls(c1, *args)``, the JAX package's ``_SIMPLE`` table
_ROWS = {"Conv": L.ConvBnAct, "Focus": L.Focus, "Bottleneck": L.Bottleneck,
         "BottleneckCSP": L.BottleneckCSP, "C3": L.C3, "C3TR": L.C3TR,
         "SPP": L.SPP, "SPPF": L.SPPF, "DWConv": L.DWConv,
         "GhostConv": L.GhostConv, "GhostBottleneck": L.GhostBottleneck,
         "MixConv2d": L.MixConv2d, "CrossConv": L.CrossConv}
_UNFUSABLE = {"MixConv2d", "CrossConv"}  # take no ``fused`` (keep their BN)
# rows that take and give int8 QTensors in the s8-storage deploy form
_QUANT_CAPABLE = {"Conv", "Focus", "Bottleneck", "C3", "SPP", "SPPF",
                  "DWConv"}


def _row(m: str, c1: int, args: tuple, fused: bool, quant: bool):
    kw = {} if m in _UNFUSABLE else {"fused": fused}
    if m in _QUANT_CAPABLE:
        kw["quant"] = quant
    return _ROWS[m](c1, args[0], *args[1:], **kw)


def _upsample(x, args):
    """torch nn.Upsample(size, scale_factor, mode) args, the JAX package's
    reading: scale 2 and nearest unless given."""
    scale = int(args[1]) if len(args) >= 2 and args[1] else 2
    mode = args[2] if len(args) >= 3 and isinstance(args[2], str) \
        else "nearest"
    if mode == "nearest":
        return nearest_upsample(x, scale)
    return bilinear_resize(x, (x.shape[2] * scale, x.shape[3] * scale))


def _nhwc(t):
    if isinstance(t, (list, tuple)):
        return tuple(_nhwc(u) for u in t)
    return t.permute(0, 2, 3, 1)


class TwoStreamDetector(nn.Module):
    """``aux_mode``: ``"reference"``, ``"full"`` or ``"off"`` (see the
    module docstring); with the aux losses on, the GPT1 levels run
    unmerged (the merge kernel returns no pattern loss).
    ``use_cem``: the CEM front end on the RGB input (without it the
    module has no ``Enhance`` submodule).
    ``fused``: BN folded into the convs (deploy form).
    ``kernel_fusion``: the fusion transformers run the fused token
    transformer kernel (the JAX package's ``pallas_fusion``).
    ``kernel_cem``: the CEM runs as the fused CEM kernel (``pallas_cem``;
    needs the BN-folded model).
    ``kernel_merge``: every fusion level runs as the fused GPT-merge kernel
    and its two ``Add2`` rows become selects (``merge_fusion_kernel``); it
    takes the place of ``kernel_fusion`` at those levels.
    ``quant``: the s8-storage deploy form (module docstring); needs the
    fused model and each conv's calibrated ``out_scale``.
    ``truncate_at``: stop after that layer and return ``{"trunc": out}``
    (NHWC), for layer-by-layer comparison."""

    def __init__(self, spec: ModelSpec, aux_mode: str = "off",
                 use_cem: bool = True, fused: bool = False,
                 kernel_fusion: bool = False, kernel_cem: bool = False,
                 kernel_merge: bool = False, quant: bool = False,
                 truncate_at: int | None = None):
        super().__init__()
        if aux_mode not in ("off", "reference", "full"):
            raise ValueError(f"aux_mode={aux_mode!r}: 'off', 'reference' "
                             "or 'full'")
        self.aux_mode = aux_mode
        self.spec = spec
        self.truncate_at = truncate_at
        self.resolved, self.save = resolve(spec)
        self.use_cem = use_cem
        if use_cem:
            self.Enhance = ContourEnhance(spec.ch_in, fused,
                                          use_kernel=kernel_cem)
        ch = [rl.c_out for rl in self.resolved]

        def ch_of(j, i):
            if j == -1:
                return ch[i - 1] if i > 0 else spec.ch_in
            return spec.ch_in if j == SECOND_INPUT else ch[j]

        mods = []
        for rl in self.resolved:
            m, a, i = rl.name, rl.args, rl.index
            c1 = ch_of(rl.f if isinstance(rl.f, int) else rl.f[0], i)
            if m in _ROWS:
                # n > 1 chains copies (reference nn.Sequential); the C3
                # family folds its repeats into ``n`` instead
                mod = _row(m, c1, a, fused, quant)
                if rl.n > 1:
                    mod = nn.Sequential(mod, *[
                        _row(m, a[0], a, fused, quant)
                        for _ in range(rl.n - 1)])
            elif m in _FUSION:
                # GPT1*'s pattern loss is computed only for the aux losses,
                # which also need the unmerged outputs
                extra = {} if m == "GPT" else {
                    "with_loss": aux_mode != "off"}
                mod = _FUSION[m](a[0], n_layer=spec.fusion_layers,
                                 use_kernel=kernel_fusion,
                                 merge_kernel=kernel_merge and (
                                     m == "GPT" or aux_mode == "off"),
                                 **extra)
            elif m == "MambaFusion":
                mod = MambaFusion(a[0])
            elif m == "Detect":
                mod = Detect(a[0], a[1], a[2], spec.strides)
            elif m in _PARAMETER_FREE:
                mod = nn.Identity()
            else:
                raise ValueError(f"unhandled module {m}")
            mods.append(mod)
        self.model = nn.ModuleList(mods)

    def forward(self, rgb: torch.Tensor, ir: torch.Tensor | None = None):
        """rgb/ir: NHWC images in [0, 1].  Returns ``train_outs`` per level
        (B, na, ny, nx, no), ``pred`` decoded (B, N, no) when not training
        (else None) and the ``aux`` loss dict."""
        aux: dict[str, torch.Tensor] = {}
        dt = next(self.parameters()).dtype
        x = rgb.permute(0, 3, 1, 2).to(dt)
        if self.use_cem:
            x = self.Enhance(x)
        x2 = None if ir is None else ir.permute(0, 3, 1, 2).to(dt)
        y: dict[int, object] = {}
        # fusion layers whose outputs are already merged into the streams
        premerged: set[int] = set()
        for rl, mod in zip(self.resolved, self.model):
            def get(j):
                if j == -1:
                    return x
                if j == SECOND_INPUT:
                    if x2 is None:
                        raise ValueError("spec needs a second (IR) input")
                    return x2
                return y[j]

            inp = [get(j) for j in rl.f] if isinstance(rl.f, tuple) \
                else get(rl.f)
            m = rl.name
            if m not in _QUANT_CAPABLE:  # everything else reads floats
                inp = deq_tree(inp, dt)
            if m == "Concat":
                x = torch.cat(inp, 1)
            elif m == "Add":
                x = inp[0] + inp[1]
            elif m == "Add2":
                if rl.f[1] in premerged:
                    x = inp[1][rl.args[0]]
                else:
                    x = inp[0] + inp[1][rl.args[0]]
            elif m in ("Upsample", "nn.Upsample"):
                x = _upsample(inp, rl.args)
            elif m == "nn.MaxPool2d":
                # torch nn.MaxPool2d(kernel_size, stride, padding)
                a = rl.args
                k = a[0]
                pd = a[2] if len(a) > 2 else 0
                x = F.max_pool2d(F.pad(inp, (pd,) * 4, value=-math.inf), k,
                                 a[1] if len(a) > 1 and a[1] else k)
            elif m == "nn.ZeroPad2d":
                x = F.pad(inp, tuple(rl.args[0]))  # left, right, top, bottom
            elif m == "Contract":
                x = L.contract(inp, rl.args[0])
            elif m == "Expand":
                x = L.expand(inp, rl.args[0])
            elif m == "MambaFusion":
                x = list(mod(inp[0], inp[1]))
            elif m in _FUSION:
                fourier = m == "GPT1_fourier"
                group = comm.active()   # a data-parallel step's, or None
                if self.aux_mode != "off" and fourier:
                    aux["contrastive"] = fusion_losses.contrastive_loss(
                        inp[0], inp[1], group=group)
                out = mod(inp[0], inp[1])
                x = list(out[:2])
                if mod.merge_kernel and not mod.training:
                    premerged.add(rl.index)
                if self.aux_mode != "off" and m != "GPT":
                    aux["pattern"] = out[2]
                    if fourier:
                        fused = (x[0] + x[1]) / 2.0
                        aux["ssim"] = fusion_losses.fusing_loss(
                            inp[0], inp[1], fused, fused, group=group)
                        if self.aux_mode == "full":
                            aux["entropy"] = fusion_losses.entropy_loss(
                                inp[0], inp[1], fused, group=group)
            elif m == "Detect":
                train_outs, pred = mod(inp, decode=not self.training)
                if "ssim" in aux:  # Combine loss (yolo_test.py:263-268)
                    if self.aux_mode == "full":
                        a1, a2, a3, a4 = AUX_WEIGHTS
                        aux["combine"] = (a1 * aux["contrastive"]
                                          + a2 * aux["ssim"]
                                          + a3 * aux["pattern"]
                                          + a4 * aux["entropy"])
                    else:
                        aux["combine"] = aux["ssim"]
                return {"train_outs": train_outs, "pred": pred, "aux": aux}
            else:
                x = mod(inp)
            if rl.index in self.save:
                y[rl.index] = x
            if self.truncate_at is not None and rl.index == self.truncate_at:
                return {"trunc": _nhwc(deq_tree(x, dt))}
        raise ValueError("spec has no Detect layer")
