"""Cross-modal fusion transformer (the GPT block), in PyTorch.

Counterpart of ``mmidet_tpu/nn/fusion.py`` for what the gpt4 deploy path
runs; reference ``models/common.py``:
  * ``SelfAttention`` / ``PreLNBlock`` <- ``SelfAttention`` /
    ``myTransformerBlock`` (common.py:1147-1267)
  * ``CrossModalTransformer``          <- ``GPT`` (common.py:1270-1368)

Attribute names are the reference's (``pos_emb``, ``trans_blocks.{j}``,
``sa.que_proj``, ``mlp.0``/``mlp.2``, ``ln_f``), so the state dict lines up
with the reference checkpoint and with the JAX variables.  Dropout is not
modelled: these modules serve the deploy path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mmidet_tpu_torch.nn.resize import adaptive_avg_pool, bilinear_resize
from mmidet_tpu_torch.nn.transformer_cuda import (fused_token_transformer,
                                                  stack_block_params)

LN_EPS = 1e-5  # torch LayerNorm default, as the reference


class SelfAttention(nn.Module):
    """Multi-head self-attention with explicit q/k/v/out projections.
    Ref: common.py:1147-1234."""

    def __init__(self, d_model: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.que_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model)
        self.val_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x):
        b, n, c = x.shape
        h, dk = self.num_heads, c // self.num_heads
        q = self.que_proj(x).view(b, n, h, dk).transpose(1, 2)
        k = self.key_proj(x).view(b, n, h, dk).transpose(1, 2)
        v = self.val_proj(x).view(b, n, h, dk).transpose(1, 2)
        att = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk)),
                            -1)
        return self.out_proj((att @ v).transpose(1, 2).reshape(b, n, c))


class PreLNBlock(nn.Module):
    """Pre-LN transformer block with exact-GELU MLP.
    Ref: myTransformerBlock, common.py:1237-1267."""

    def __init__(self, d_model: int, num_heads: int = 8, block_exp: int = 4):
        super().__init__()
        self.ln_input = nn.LayerNorm(d_model, eps=LN_EPS)
        self.sa = SelfAttention(d_model, num_heads)
        self.ln_output = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(d_model, block_exp * d_model),
                                 nn.GELU(),
                                 nn.Linear(block_exp * d_model, d_model))

    def forward(self, x):
        x = x + self.sa(self.ln_input(x))
        return x + self.mlp(self.ln_output(x))


class _TokenTransformer(nn.Module):
    """Pooled (B, C, gh, gw) pair -> 2*gh*gw tokens (the RGB grid
    row-major, then the IR grid) -> n_layer blocks -> ``ln_f`` -> two
    (B, C, gh, gw) maps.

    ``use_kernel=True`` (deploy, eval mode): the block stack runs as the
    fused token-transformer kernel in bf16 (``nn.transformer_cuda``), as
    ``use_pallas`` does in the JAX package; ``ln_f`` stays outside."""

    def __init__(self, d_model: int, num_heads: int = 8, block_exp: int = 4,
                 n_layer: int = 8, grid: tuple[int, int] = (8, 8),
                 use_kernel: bool = False):
        super().__init__()
        self.d_model, self.num_heads, self.grid = d_model, num_heads, grid
        self.use_kernel = use_kernel
        self.pos_emb = nn.Parameter(
            torch.zeros(1, 2 * grid[0] * grid[1], d_model))
        self.trans_blocks = nn.Sequential(*[
            PreLNBlock(d_model, num_heads, block_exp) for _ in range(n_layer)])
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        for m in self.modules():  # reference GPT._init_weights
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.02)
                nn.init.zeros_(m.bias)

    def forward(self, rgb_p, ir_p):
        b = rgb_p.shape[0]
        gh, gw = self.grid
        tok = torch.cat([rgb_p.flatten(2).transpose(1, 2),
                         ir_p.flatten(2).transpose(1, 2)], 1)
        x = tok + self.pos_emb.to(tok.dtype)
        if self.use_kernel and not self.training:
            x = fused_token_transformer(
                x.to(torch.bfloat16), stack_block_params(self.trans_blocks),
                self.num_heads).to(tok.dtype)
        else:
            x = self.trans_blocks(x)
        x = self.ln_f(x)
        rgb_o = x[:, :gh * gw].transpose(1, 2).reshape(b, -1, gh, gw)
        ir_o = x[:, gh * gw:].transpose(1, 2).reshape(b, -1, gh, gw)
        return rgb_o, ir_o


class CrossModalTransformer(_TokenTransformer):
    """Plain cross-modal transformer fusion (GPT, common.py:1270-1368):
    avg-pool both streams to the 8x8 grid, run the token transformer,
    bilinear-upsample back.  Returns (rgb_out, ir_out), NCHW."""

    def forward(self, rgb, ir):
        h, w = rgb.shape[2], rgb.shape[3]
        rgb_o, ir_o = super().forward(adaptive_avg_pool(rgb, self.grid),
                                      adaptive_avg_pool(ir, self.grid))
        return bilinear_resize(rgb_o, (h, w)), bilinear_resize(ir_o, (h, w))
