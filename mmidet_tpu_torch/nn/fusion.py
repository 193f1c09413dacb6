"""Cross-modal fusion blocks, in PyTorch: the plain transformer fusion
(GPT) and the Fusion Focus Module's two forms (GPT1, GPT1_fourier).

Counterpart of ``mmidet_tpu/nn/fusion.py``; reference ``models/common.py``:
  * ``SelfAttention`` / ``PreLNBlock`` <- ``SelfAttention`` /
    ``myTransformerBlock`` (common.py:1147-1267)
  * ``CrossModalTransformer``          <- ``GPT`` (common.py:1270-1368)
  * ``PatternFusion``                  <- ``GPT1`` (common.py:142-296)
  * ``FourierPatternFusion``           <- ``GPT1_fourier`` (common.py:299-552)
  * ``frequency_split``      <- ``extract_frequency2`` (common.py:37-69)

Attribute names are the reference's (``pos_emb``, ``trans_blocks.{j}``,
``sa.que_proj``, ``mlp.0``/``mlp.2``, ``ln_f``, and the pattern gate's
``conv1``/``conv2`` directly on the fusion module), so the state dict lines
up with the reference checkpoint and with the JAX variables (whose
``trans`` and ``pattern`` scopes are flat in the reference).  Dropout sits
where the reference and the JAX package put it (on the embedded tokens,
the attention weights, the attention output and the MLP output, all 0.1)
as ``Dropout`` modules (``nn.Dropout``, which draws the global batch's
masks in a data-parallel step), so
``.eval()`` turns it off and a test can set ``p = 0``; ``.train()`` is the
JAX package's ``train=True``.  Tensors are NCHW.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from mmidet_tpu_torch import kernels
from mmidet_tpu_torch.nn.fusion_cuda import fused_gpt_merge
from mmidet_tpu_torch.nn.resize import adaptive_avg_pool, bilinear_resize
from mmidet_tpu_torch.nn.transformer_cuda import (fused_token_transformer,
                                                  prepare_stack,
                                                  stack_block_params)
from mmidet_tpu_torch.parallel import comm

LN_EPS = 1e-5  # torch LayerNorm default, as the reference
DROP = 0.1     # embd_pdrop, attn_pdrop, resid_pdrop of the reference's GPT


@functools.lru_cache(maxsize=None)
def _freq_masks(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """(high_keep, low_keep) boolean masks over the *shifted* spectrum,
    reproducing extract_frequency2's slice arithmetic exactly (numpy
    slicing shares python/torch semantics, negative bounds included)."""
    crow, ccol = h // 2, w // 2
    threshold = crow + ccol // 4
    high = np.ones((h, w), bool)
    high[crow - threshold:crow + threshold,
         ccol - threshold:ccol + threshold] = False
    low = np.ones((h, w), bool)
    low[:crow - threshold, :] = False
    low[crow + threshold:, :] = False
    low[:, :ccol - threshold] = False
    low[:, ccol + threshold:] = False
    return high, low


def frequency_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW -> (low, high) real-valued frequency components: fft2 -> shift
    -> mask -> unshift -> ifft2 -> real, computed in f32.  The reference's
    ``.half()`` on a complex tensor drops the imaginary part, so the real
    part is taken explicitly.  ``torch.fft`` takes no bf16 at these sizes,
    so under ``torch.autocast`` the transform runs with autocast off on
    the f32 copy, and the parts come back in ``x``'s dtype."""
    high_keep, low_keep = (torch.from_numpy(m).to(x.device)
                           for m in _freq_masks(x.shape[2], x.shape[3]))
    with torch.autocast(x.device.type, enabled=False):
        fs = torch.fft.fftshift(torch.fft.fft2(x.float()), dim=(-2, -1))

        def back(keep):
            return torch.fft.ifft2(torch.fft.ifftshift(
                fs * keep, dim=(-2, -1))).real.to(x.dtype)
        return back(low_keep), back(high_keep)


def separation_loss(m: torch.Tensor, group=None) -> torch.Tensor:
    """sum_{i<j} <m_i, m_j> / (l*(l-1)) over the rows of m (l, d), in the
    closed form (|sum_i m_i|^2 - sum_i |m_i|^2) / 2.  Ref: common.py:128.
    ``group``: a ``comm.DataGroup`` whose ranks hold the rows between
    them."""
    if group is None:
        l = m.shape[0]
        s = m.sum(0)
        return (torch.dot(s, s) - (m * m).sum()) / 2.0 / (l * (l - 1))
    s, q, l = comm.global_sum([m.sum(0), (m * m).sum(),
                               m.new_full((1,), m.shape[0])], group.group)
    return ((torch.dot(s, s) - q) / 2.0 / (l * (l - 1))).reshape(())


class Dropout(nn.Dropout):
    """``nn.Dropout``; inside a data-parallel step (``comm.data_group``)
    every rank draws the mask of the whole global batch from the step's
    generator and keeps its rows, so that the masks are the global batch's
    on any mesh."""

    def forward(self, x):
        g = comm.active()
        if g is None or not self.training or self.p == 0:
            return super().forward(x)
        keep = torch.empty((g.total,) + tuple(x.shape[1:]), device=x.device)
        keep = keep.bernoulli_(1.0 - self.p, generator=g.gen)
        keep = keep[g.offset:g.offset + x.shape[0]]
        return x * (keep / (1.0 - self.p)).to(x.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with explicit q/k/v/out projections,
    dropout on the attention weights and on the output.
    Ref: common.py:1147-1234."""

    def __init__(self, d_model: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.que_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model)
        self.val_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.attn_drop = Dropout(DROP)
        self.resid_drop = Dropout(DROP)

    def forward(self, x):
        b, n, c = x.shape
        h, dk = self.num_heads, c // self.num_heads
        q = self.que_proj(x).view(b, n, h, dk).transpose(1, 2)
        k = self.key_proj(x).view(b, n, h, dk).transpose(1, 2)
        v = self.val_proj(x).view(b, n, h, dk).transpose(1, 2)
        att = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk)),
                            -1)
        att = self.attn_drop(att)
        return self.resid_drop(
            self.out_proj((att @ v).transpose(1, 2).reshape(b, n, c)))


class PreLNBlock(nn.Module):
    """Pre-LN transformer block with exact-GELU MLP, dropout after the MLP.
    Ref: myTransformerBlock, common.py:1237-1267."""

    def __init__(self, d_model: int, num_heads: int = 8, block_exp: int = 4):
        super().__init__()
        self.ln_input = nn.LayerNorm(d_model, eps=LN_EPS)
        self.sa = SelfAttention(d_model, num_heads)
        self.ln_output = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(d_model, block_exp * d_model),
                                 nn.GELU(),
                                 nn.Linear(block_exp * d_model, d_model),
                                 Dropout(DROP))

    def forward(self, x):
        x = x + self.sa(self.ln_input(x))
        return x + self.mlp(self.ln_output(x))


class _TokenTransformer(nn.Module):
    """Pooled (B, C, gh, gw) pair -> 2*gh*gw tokens (the RGB grid
    row-major, then the IR grid) -> n_layer blocks -> ``ln_f`` -> two
    (B, C, gh, gw) maps.

    ``use_kernel=True`` (deploy, eval mode): the block stack runs as the
    fused token-transformer kernel in bf16 (``nn.transformer_cuda``), as
    ``use_pallas`` does in the JAX package; ``ln_f`` stays outside.

    ``merge_kernel=True`` (deploy, eval mode): the subclasses run their
    whole pool -> (gate) -> transformer -> upsample -> Add2 sequence as the
    fused GPT-merge kernel (``nn.fusion_cuda``) and return the MERGED
    streams (rgb + up, ir + up); the caller must turn the downstream Add2
    layers into selects.  Same parameters either way."""

    def __init__(self, d_model: int, num_heads: int = 8, block_exp: int = 4,
                 n_layer: int = 8, grid: tuple[int, int] = (8, 8),
                 use_kernel: bool = False, merge_kernel: bool = False):
        super().__init__()
        if merge_kernel and tuple(grid) != (8, 8):
            raise ValueError("the merge kernel pools to an 8x8 grid")
        self.d_model, self.num_heads, self.grid = d_model, num_heads, grid
        self.use_kernel, self.merge_kernel = use_kernel, merge_kernel
        self._stack, self._stack_key = None, None
        self.pos_emb = nn.Parameter(
            torch.zeros(1, 2 * grid[0] * grid[1], d_model))
        self.drop = Dropout(DROP)
        self.trans_blocks = nn.Sequential(*[
            PreLNBlock(d_model, num_heads, block_exp) for _ in range(n_layer)])
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        for m in self.modules():  # reference GPT._init_weights
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.02)
                nn.init.zeros_(m.bias)

    def _stacked(self, device):
        """The blocks' stacked weights for the kernels.  On a card they are
        the kernels' own buffers (``prepare_stack``), kept until a
        parameter changes; in a graph that ``torch.export`` traces, which
        has no storage to stamp, they are made on every call."""
        if device.type != "cuda":
            return stack_block_params(self.trans_blocks)
        if torch.compiler.is_exporting():
            return prepare_stack(stack_block_params(self.trans_blocks),
                                 device)
        key = (device, kernels.stamp(self.trans_blocks.parameters()))
        if key != self._stack_key:
            self._stack = prepare_stack(
                stack_block_params(self.trans_blocks), device)
            self._stack_key = key
        return self._stack

    def forward(self, rgb_p, ir_p):
        b = rgb_p.shape[0]
        gh, gw = self.grid
        tok = torch.cat([rgb_p.flatten(2).transpose(1, 2),
                         ir_p.flatten(2).transpose(1, 2)], 1)
        x = tok + self.pos_emb.to(tok.dtype)
        if self.use_kernel and not self.training:  # eval: no dropout
            x = fused_token_transformer(
                x.to(torch.bfloat16), self._stacked(x.device),
                self.num_heads).to(tok.dtype)
        else:
            x = self.trans_blocks(self.drop(x))
        x = self.ln_f(x)
        rgb_o = x[:, :gh * gw].transpose(1, 2).reshape(b, -1, gh, gw)
        ir_o = x[:, gh * gw:].transpose(1, 2).reshape(b, -1, gh, gw)
        return rgb_o, ir_o

    def _merged(self, rgb, ir, gate=None):
        """The fused GPT-merge kernel on NCHW streams: merged streams,
        NCHW views of the kernel's NHWC outputs, in the streams' dtype."""
        ro, io = fused_gpt_merge(
            rgb.permute(0, 2, 3, 1).to(torch.bfloat16),
            ir.permute(0, 2, 3, 1).to(torch.bfloat16),
            self._stacked(rgb.device), self.pos_emb,
            self.ln_f.weight, self.ln_f.bias, self.num_heads, gate)
        return (ro.permute(0, 3, 1, 2).to(rgb.dtype),
                io.permute(0, 3, 1, 2).to(ir.dtype))


class CrossModalTransformer(_TokenTransformer):
    """Plain cross-modal transformer fusion (GPT, common.py:1270-1368):
    avg-pool both streams to the 8x8 grid, run the token transformer,
    bilinear-upsample back.  Returns (rgb_out, ir_out), NCHW; with
    ``merge_kernel`` the merged streams."""

    def forward(self, rgb, ir):
        if self.merge_kernel and not self.training:
            return self._merged(rgb, ir)
        h, w = rgb.shape[2], rgb.shape[3]
        rgb_o, ir_o = super().forward(adaptive_avg_pool(rgb, self.grid),
                                      adaptive_avg_pool(ir, self.grid))
        return bilinear_resize(rgb_o, (h, w)), bilinear_resize(ir_o, (h, w))


def _mask_rows(m: torch.Tensor) -> torch.Tensor:
    """(B, 8, gh, gw) mask -> (B*8, gh*gw) rows in the reference's
    ``view(-1, h*w)`` order (batch-major, then mask channel)."""
    return m.reshape(m.shape[0] * m.shape[1], -1)


class PatternFusion(_TokenTransformer):
    """Pattern-attention fusion (no fourier branch).  Ref: GPT1,
    common.py:142-296.  ``conv1`` (-> 8 channels) + sigmoid gives the
    pattern mask, ``conv2`` maps it back to C, and the product gates the
    pooled features before the token transformer.  Returns
    (rgb_out, ir_out, pattern_loss); the loss is computed in eval mode too,
    unless the module was built with ``with_loss=False`` by a caller that
    drops it (the deploy detector): then it is 0 and the masks that feed
    only the loss are not computed.

    With ``merge_kernel`` (eval mode) the returned pair is the MERGED
    streams and the pattern loss is 0: it is training-only dataflow."""

    fourier = False

    def __init__(self, d_model: int, num_heads: int = 8, block_exp: int = 4,
                 n_layer: int = 8, grid: tuple[int, int] = (8, 8),
                 use_kernel: bool = False, merge_kernel: bool = False,
                 with_loss: bool = True):
        super().__init__(d_model, num_heads, block_exp, n_layer, grid,
                         use_kernel, merge_kernel)
        self.with_loss = with_loss
        self.conv1 = nn.Conv2d(d_model, 8, 1, bias=False)
        self.conv2 = nn.Conv2d(8, d_model, 1, bias=False)

    def mask(self, x):
        return torch.sigmoid(self.conv1(x))

    def forward(self, rgb, ir):
        if self.merge_kernel and not self.training:
            gate = {"g1": self.conv1.weight.flatten(1).T,
                    "g2": self.conv2.weight.flatten(1).T}
            return (*self._merged(rgb, ir, gate), rgb.new_zeros(()))
        h, w = rgb.shape[2], rgb.shape[3]
        b = rgb.shape[0]
        rgb_p = adaptive_avg_pool(rgb, self.grid)
        ir_p = adaptive_avg_pool(ir, self.grid)
        rgb_m, ir_m = self.mask(rgb_p), self.mask(ir_p)
        pattern_loss = rgb.new_zeros(())
        if self.with_loss:
            rows = [_mask_rows(rgb_m), _mask_rows(ir_m)]
            g = comm.active()
            if self.fourier:
                # the high-frequency branch feeds only the separation loss:
                # the first B rows of each of its masks (len_fea_half =
                # B*8 // 8, common.py:487), B and the rows the global
                # batch's in a data-parallel step
                first = b if g is None else \
                    min(max(g.total - 8 * g.offset, 0), 8 * b)
                rows += [_mask_rows(self.mask(frequency_split(p)[1] * p))[
                    :first] for p in (rgb_p, ir_p)]
            pattern_loss = separation_loss(torch.cat(rows, 0), g)
        rgb_o, ir_o = super().forward(self.conv2(rgb_m) * rgb_p,
                                      self.conv2(ir_m) * ir_p)
        return (bilinear_resize(rgb_o, (h, w)), bilinear_resize(ir_o, (h, w)),
                pattern_loss)


class FourierPatternFusion(PatternFusion):
    """The Fusion Focus Module: FFT high-frequency attention + pattern gate
    + cross-modal transformer.  Ref: GPT1_fourier, common.py:299-552.  The
    gating path uses the plain pooled-feature masks, exactly as the
    reference; so at inference its dataflow is ``PatternFusion``'s."""

    fourier = True
