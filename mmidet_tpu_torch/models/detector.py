"""The two-stream (visible + infrared) detection model, in PyTorch.

Counterpart of ``mmidet_tpu/models/detector.py:TwoStreamDetector`` for the
inference path (``aux_mode="off"``); reference ``Model`` / ``forward_once``
(``models/yolo_test.py:77-276``).  The layer graph is the ``ModelSpec``,
executed as a DAG: the ``-4`` route feeds the IR image to the second
stream.  Modules sit at ``model.{i}`` (parameter-free layers hold an
``nn.Identity``) and the CEM at ``Enhance``, the reference's state-dict
names.

Public layout is the JAX package's: images NHWC ``(B, H, W, 3)`` in [0, 1];
``pred`` ``(B, N, 5+nc)``; ``train_outs`` per level ``(B, na, ny, nx, no)``.
Inside, tensors are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from mmidet_tpu_torch.models.detect_head import Detect
from mmidet_tpu_torch.models.spec import SECOND_INPUT, ModelSpec, resolve
from mmidet_tpu_torch.nn import layers as L
from mmidet_tpu_torch.nn.cem import ContourEnhance
from mmidet_tpu_torch.nn.fusion import (CrossModalTransformer,
                                        FourierPatternFusion, PatternFusion)
from mmidet_tpu_torch.nn.resize import nearest_upsample

_PARAMETER_FREE = {"Concat", "Add", "Add2", "Upsample"}
_FUSION = {"GPT": CrossModalTransformer, "GPT1": PatternFusion,
           "GPT1_fourier": FourierPatternFusion}


def _nhwc(t):
    if isinstance(t, (list, tuple)):
        return tuple(_nhwc(u) for u in t)
    return t.permute(0, 2, 3, 1)


class TwoStreamDetector(nn.Module):
    """``fused``: BN folded into the convs (deploy form).
    ``kernel_fusion``: the fusion transformers run the fused token
    transformer kernel (the JAX package's ``pallas_fusion``).
    ``kernel_cem``: the CEM runs as the fused CEM kernel (``pallas_cem``;
    needs the BN-folded model).
    ``kernel_merge``: every fusion level runs as the fused GPT-merge kernel
    and its two ``Add2`` rows become selects (``merge_fusion_kernel``); it
    takes the place of ``kernel_fusion`` at those levels.
    ``truncate_at``: stop after that layer and return ``{"trunc": out}``
    (NHWC), for layer-by-layer comparison."""

    def __init__(self, spec: ModelSpec, aux_mode: str = "off",
                 fused: bool = False, kernel_fusion: bool = False,
                 kernel_cem: bool = False, kernel_merge: bool = False,
                 truncate_at: int | None = None):
        super().__init__()
        if aux_mode != "off":
            raise NotImplementedError(
                f"aux_mode={aux_mode!r}: only the inference path is ported")
        self.spec = spec
        self.truncate_at = truncate_at
        self.resolved, self.save = resolve(spec)
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
            if m == "Conv":
                mod = L.ConvBnAct(c1, a[0], *a[1:], fused=fused)
            elif m == "Focus":
                mod = L.Focus(c1, a[0], *a[1:], fused=fused)
            elif m == "C3":
                mod = L.C3(c1, a[0], *a[1:], fused=fused)
            elif m == "SPP":
                mod = L.SPP(c1, a[0], *a[1:], fused=fused)
            elif m in _FUSION:
                # the inference path drops GPT1*'s pattern loss: not computed
                extra = {} if m == "GPT" else {"with_loss": False}
                mod = _FUSION[m](a[0], n_layer=spec.fusion_layers,
                                 use_kernel=kernel_fusion,
                                 merge_kernel=kernel_merge, **extra)
            elif m == "Detect":
                mod = Detect(a[0], a[1], a[2], spec.strides)
            elif m in _PARAMETER_FREE:
                mod = nn.Identity()
            else:
                raise NotImplementedError(f"module {m!r} is not ported yet")
            if rl.n != 1:
                raise NotImplementedError(f"repeated {m!r} rows")
            mods.append(mod)
        self.model = nn.ModuleList(mods)

    def forward(self, rgb: torch.Tensor, ir: torch.Tensor):
        dt = next(self.parameters()).dtype
        x = self.Enhance(rgb.permute(0, 3, 1, 2).to(dt))
        x2 = ir.permute(0, 3, 1, 2).to(dt)
        y: dict[int, object] = {}
        # fusion layers whose outputs are already merged into the streams
        premerged: set[int] = set()
        for rl, mod in zip(self.resolved, self.model):
            def get(j):
                if j == -1:
                    return x
                return x2 if j == SECOND_INPUT else y[j]

            inp = [get(j) for j in rl.f] if isinstance(rl.f, tuple) \
                else get(rl.f)
            m = rl.name
            if m == "Concat":
                x = torch.cat(inp, 1)
            elif m == "Add":
                x = inp[0] + inp[1]
            elif m == "Add2":
                if rl.f[1] in premerged:
                    x = inp[1][rl.args[0]]
                else:
                    x = inp[0] + inp[1][rl.args[0]]
            elif m == "Upsample":
                # args follow torch nn.Upsample(size, scale_factor, mode)
                if rl.args[2] != "nearest":
                    raise NotImplementedError(f"Upsample mode {rl.args[2]!r}")
                x = nearest_upsample(inp, int(rl.args[1]))
            elif m in _FUSION:
                x = list(mod(inp[0], inp[1])[:2])  # GPT1*: drop pattern loss
                if mod.merge_kernel and not mod.training:
                    premerged.add(rl.index)
            elif m == "Detect":
                train_outs, pred = mod(inp)
                return {"train_outs": train_outs, "pred": pred}
            else:
                x = mod(inp)
            if rl.index in self.save:
                y[rl.index] = x
            if self.truncate_at is not None and rl.index == self.truncate_at:
                return {"trunc": _nhwc(x)}
        raise ValueError("spec has no Detect layer")
