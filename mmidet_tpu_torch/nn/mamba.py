"""Mamba selective-state-space blocks and the ``MambaFusion`` cross-modal
fusion, in PyTorch.

Counterpart of ``mmidet_tpu/nn/mamba.py``; reference ``models/mamba.py``
(MambaConfig, Mamba/ResidualBlock/MambaBlock/RMSNorm, the selective scan and
the O(1) autoregressive ``step``) and ``models/pscan.py`` (the parallel
scan).

The SSM's recurrence ``h[t] = a[t] * h[t-1] + x[t]`` is associative under
``(a1, x1) then (a2, x2) = (a1 * a2, a2 * x1 + x2)``; ``linear_recurrence``
computes it as a Hillis-Steele scan over the length axis: log2(L) rounds of
whole-tensor products, so a 128-token sequence costs 7 rounds instead of
128 dependent steps, and autograd differentiates it as it stands.  The JAX
package computes the same scan with ``jax.lax.associative_scan``, outside
any Pallas kernel.

Parameter names are the JAX package's leaves under the reference's module
names, so ``bridge.py`` maps them one to one and ``label_params`` gives
them the JAX package's groups: the depthwise conv is held as
``conv1d_kernel`` ``(d_conv, 1, d_inner)`` and ``conv1d_bias``, and
``A_log``, ``D`` and RMSNorm's ``weight`` are plain parameters (all in the
``bn`` group).  Tokens are ``(B, L, d)``; the fusion block takes and
returns NCHW maps.

The SSM (``delta``, ``dA``, ``dBx``, ``h`` and the readout) runs in f32
whatever the model's dtype, with plain elementwise ops so that autocast
leaves it in f32 too; RMSNorm takes ``mean(x^2)`` in f32 and casts its
``rsqrt`` to x's dtype before the product, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.nn.resize import adaptive_avg_pool, bilinear_resize


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Ref: mamba.py MambaConfig."""
    d_model: int
    n_layers: int = 2
    dt_rank: int | None = None
    d_state: int = 16
    expand_factor: int = 2
    d_conv: int = 4
    dt_min: float = 1e-3
    dt_max: float = 0.1
    dt_init_floor: float = 1e-4

    @property
    def d_inner(self) -> int:
        return self.expand_factor * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else \
            math.ceil(self.d_model / 16)


def linear_recurrence(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h[t] = a[t] * h[t-1] + x[t] over axis 1 (length), h[-1] = 0, for
    (B, L, ...) tensors: a Hillis-Steele inclusive scan, ceil(log2 L)
    rounds, each combining every element with the one ``s`` before it."""
    s, n = 1, a.shape[1]
    while s < n:
        x = torch.cat([x[:, :s], a[:, s:] * x[:, :-s] + x[:, s:]], 1)
        if 2 * s < n:  # the last round's products of a are not read
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1)
        s *= 2
    return x


class RMSNorm(nn.Module):
    """Ref: mamba.py RMSNorm."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x):
        ms = x.float().square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(ms + self.eps).to(x.dtype)
        return y * self.weight.to(x.dtype)


class MambaBlock(nn.Module):
    """Selective SSM block. Ref: mamba.py MambaBlock (in_proj -> depthwise
    causal conv1d -> SiLU -> SSM -> gate -> out_proj).  The initialisation
    is the JAX package's: S4D-real ``A_log``, ``D`` = 1, the depthwise
    conv U(+-1/sqrt(d_conv)), ``dt_proj`` U(+-rank^-0.5) with the bias the
    inverse softplus of a log-uniform dt in [dt_min, dt_max]."""

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        self.cfg = cfg
        di, n = cfg.d_inner, cfg.d_state
        self.in_proj = nn.Linear(cfg.d_model, 2 * di, bias=False)
        self.conv1d_kernel = nn.Parameter(torch.empty(cfg.d_conv, 1, di))
        self.conv1d_bias = nn.Parameter(torch.empty(di))
        self.x_proj = nn.Linear(di, cfg.rank + 2 * n, bias=False)
        self.dt_proj = nn.Linear(cfg.rank, di, bias=True)
        self.out_proj = nn.Linear(di, cfg.d_model, bias=False)
        self.A_log = nn.Parameter(torch.empty(di, n))
        self.D = nn.Parameter(torch.empty(di))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        cfg = self.cfg
        bound = 1.0 / math.sqrt(cfg.d_conv)
        self.conv1d_kernel.uniform_(-bound, bound)
        self.conv1d_bias.uniform_(-bound, bound)
        self.dt_proj.weight.uniform_(-cfg.rank ** -0.5, cfg.rank ** -0.5)
        u = torch.rand(self.dt_proj.bias.shape, device=self.D.device)
        dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                       + math.log(cfg.dt_min)).clamp(min=cfg.dt_init_floor)
        self.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_log.copy_(torch.log(torch.arange(
            1, cfg.d_state + 1, dtype=torch.float32,
            device=self.D.device)).expand_as(self.A_log))
        self.D.fill_(1.0)

    def _conv(self, xs):
        """Causal depthwise conv over the length axis of (B, L, di)."""
        k = self.conv1d_kernel.permute(2, 1, 0).to(xs.dtype)  # (di, 1, kw)
        xp = F.pad(xs.transpose(1, 2), (self.cfg.d_conv - 1, 0))
        xc = F.conv1d(xp, k, groups=self.cfg.d_inner).transpose(1, 2)
        return F.silu(xc + self.conv1d_bias.to(xs.dtype))

    def _ssm(self, x):
        cfg = self.cfg
        n = cfg.d_state
        A = -torch.exp(self.A_log.float())                      # (di, n)
        delta, bm, cm = self.x_proj(x).split([cfg.rank, n, n], -1)
        delta = F.softplus(self.dt_proj(delta).float())         # (b, l, di)
        dA = torch.exp(delta[..., None] * A)
        dbx = delta[..., None] * bm[:, :, None, :].float() \
            * x[..., None].float()
        h = linear_recurrence(dA, dbx)                          # (b, l, di, n)
        y = (h * cm[:, :, None, :].float()).sum(-1)
        y = y + self.D.float() * x.float()
        return y.to(x.dtype)

    def forward(self, x):
        xs, z = self.in_proj(x).chunk(2, -1)
        y = self._ssm(self._conv(xs)) * F.silu(z)
        return self.out_proj(y)


class ResidualBlock(nn.Module):
    """RMSNorm + MambaBlock residual. Ref: mamba.py ResidualBlock."""

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model)
        self.mixer = MambaBlock(cfg)

    def forward(self, x):
        return x + self.mixer(self.norm(x))


class Mamba(nn.Module):
    """Stack of residual Mamba blocks. Ref: mamba.py Mamba."""

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(ResidualBlock(cfg)
                                    for _ in range(cfg.n_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def mamba_step(block: MambaBlock, x_t, cache):
    """O(1) single-token step of one ``MambaBlock`` with its (h, conv
    window) cache.  Ref: mamba.py Mamba.step; JAX ``mamba_step``, which
    takes the block's flax params and config where this takes the module.

    x_t: (B, d_model); cache: (h (B, d_inner, d_state), inputs
    (B, d_conv-1, d_inner)).  Returns (y_t, new cache)."""
    cfg = block.cfg
    n = cfg.d_state
    h, conv_in = cache
    xs, z = block.in_proj(x_t).chunk(2, -1)
    window = torch.cat([conv_in, xs[:, None]], 1)            # (B, d_conv, di)
    k = block.conv1d_kernel[:, 0, :]                         # (d_conv, di)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, k) + block.conv1d_bias)
    A = -torch.exp(block.A_log)
    delta, bm, cm = block.x_proj(xc).split([cfg.rank, n, n], -1)
    delta = F.softplus(block.dt_proj(delta))
    dA = torch.exp(delta[..., None] * A[None])
    dbx = delta[..., None] * bm[:, None, :] * xc[..., None]
    h = dA * h + dbx
    y = torch.einsum("bin,bn->bi", h, cm) + block.D * xc
    out = block.out_proj(y * F.silu(z))
    return out, (h, window[:, 1:])


def mamba_cache_init(cfg: MambaConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device=None):
    """Fresh per-layer (h, conv window) caches: h at zero and d_conv-1
    zero inputs, the padded conv's left edge."""
    return [(torch.zeros(batch, cfg.d_inner, cfg.d_state, dtype=dtype,
                         device=device),
             torch.zeros(batch, cfg.d_conv - 1, cfg.d_inner, dtype=dtype,
                         device=device))
            for _ in range(cfg.n_layers)]


def residual_step(layer: ResidualBlock, x_t, cache):
    """O(1) step through one ``ResidualBlock``: RMSNorm -> mixer step ->
    + x.  Ref: mamba.py ResidualBlock.step."""
    out, cache = mamba_step(layer.mixer, layer.norm(x_t), cache)
    return x_t + out, cache


def mamba_stack_step(mamba: Mamba, x_t, caches):
    """O(1) step through a whole ``Mamba`` stack, one cache per layer
    (from ``mamba_cache_init``).  Ref: mamba.py Mamba.step.  Returns
    (y_t, new caches)."""
    new_caches = []
    for layer, c in zip(mamba.layers, caches):
        x_t, c = residual_step(layer, x_t, c)
        new_caches.append(c)
    return x_t, new_caches


class MambaFusion(nn.Module):
    """Cross-modal fusion through a bidirectional Mamba stack over the
    pooled tokens of both streams: adaptive pool to ``grid``, the RGB
    tokens then the IR tokens as one sequence, a forward stack and a stack
    over the reversed sequence (``fwd``, ``bwd``), ``norm_f`` over their
    sum, and each stream's half resized back (bilinear).  Returns
    (rgb_out, ir_out) at the inputs' size; the detector's ``Add2`` rows add
    them to the streams."""

    def __init__(self, d_model: int, n_layers: int = 4,
                 grid: tuple[int, int] = (8, 8)):
        super().__init__()
        self.grid = tuple(grid)
        cfg = MambaConfig(d_model=d_model, n_layers=n_layers)
        self.fwd = Mamba(cfg)
        self.bwd = Mamba(cfg)
        self.norm_f = RMSNorm(d_model)

    def forward(self, rgb, ir):
        b, c, h, w = rgb.shape
        gh, gw = self.grid
        tok = torch.cat([adaptive_avg_pool(t, self.grid).flatten(2)
                         for t in (rgb, ir)], 2).transpose(1, 2)
        out = self.fwd(tok) + self.bwd(tok.flip(1)).flip(1)
        out = self.norm_f(out).transpose(1, 2)
        r = out[:, :, :gh * gw].reshape(b, c, gh, gw)
        i = out[:, :, gh * gw:].reshape(b, c, gh, gw)
        return bilinear_resize(r, (h, w)), bilinear_resize(i, (h, w))
