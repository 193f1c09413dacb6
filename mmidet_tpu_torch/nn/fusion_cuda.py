"""The fused GPT merge: a hand-written CUDA kernel and its plain PyTorch
version.

Counterpart of ``mmidet_tpu/nn/fusion_pallas.py``.  The kernel
(``csrc/gpt_merge.cu``) replaces the TPU kernel ``fused_gpt_merge`` there:
one whole fusion level (adaptive-avg-pool of both streams to 8x8, the
optional pattern gate, pos-emb, the L-layer token transformer, ``ln_f``,
bilinear upsample, and the two ``Add2`` sums) in one call that returns the
MERGED streams.

Public layout is the JAX function's: streams ``(B, H, W, C)`` NHWC bf16,
``pos_emb (1, 128, C)``, gate ``{"g1": (C, 8), "g2": (8, C)}``; the stacked
layer weights are the port's (``transformer_cuda.stack_block_params``,
torch Linear layout).  Both versions here round where the Pallas kernel
rounds (``fusion_pallas.py:69-133, 174-182``): window row sums, their
means, the column sums of those and their means are each bf16 (sums
accumulate in f32); the gate's mask and the gated token are bf16; the
pos-emb sum is bf16; the layers round as the token-transformer kernel;
``ln_f``'s output is bf16; the upsample runs in f32 on the bf16 tokens, rows
first, then columns, and is rounded to bf16 once; the sum into the stream
is bf16.

The kernel is the custom op ``mmidet::fused_gpt_merge``
(``torch.library``): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and its fake implementation gives the
two outputs' shapes, so that ``torch.export`` traces a model that reaches
it.  The wrapper ``fused_gpt_merge`` calls the op, so an eager call and an
exported graph take the same route.  The op takes the stacked weights as
``prepare_stack`` makes them, a list in ``STACK_KEYS`` order, and the gate
as two optional tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mmidet_tpu_torch import kernels
from mmidet_tpu_torch.nn.transformer_cuda import (
    LN_EPS, STACK_KEYS, TOKENS, fused_token_transformer_reference,
    prepare_stack)

GRID = 8  # tokens per side and stream


def _bf16r(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _pool_windows(n_in: int, n_out: int = GRID) -> list[tuple[int, int]]:
    """torch AdaptiveAvgPool1d window (start, length) per output index."""
    return [((i * n_in) // n_out,
             math.ceil((i + 1) * n_in / n_out) - (i * n_in) // n_out)
            for i in range(n_out)]


def _pool8(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) bf16 values as f32 -> (B, 64, C): rows, then columns;
    each sum and each mean rounded to bf16."""
    b, h, w, c = x.shape
    rows = torch.stack([_bf16r(_bf16r(x[:, s:s + n].sum(1)) / n)
                        for s, n in _pool_windows(h)], 1)     # (B, 8, W, C)
    cols = torch.stack([_bf16r(_bf16r(rows[:, :, s:s + n].sum(2)) / n)
                        for s, n in _pool_windows(w)], 2)     # (B, 8, 8, C)
    return cols.reshape(b, GRID * GRID, c)


def _bilinear_src(n_out: int, device):
    """Source pair and weight per output index, half-pixel centres,
    clamped (``F.interpolate(mode="bilinear", align_corners=False)``),
    computed in f32 as the kernel computes them."""
    scale = torch.tensor(GRID / n_out, dtype=torch.float32, device=device)
    idx = torch.arange(n_out, dtype=torch.float32, device=device)
    src = ((idx + 0.5) * scale - 0.5).clamp(0.0, GRID - 1.0)
    lo = src.floor().long()
    return lo, (lo + 1).clamp(max=GRID - 1), src - lo.float()


def _upsample(z: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 8, 8, C) bf16 values as f32 -> (B, H, W, C), f32 arithmetic,
    rows first, then columns, rounded to bf16 once."""
    lo, hi, wv = _bilinear_src(h, z.device)
    wv = wv.view(1, h, 1, 1)
    zh = z[:, lo] * (1.0 - wv) + z[:, hi] * wv
    lo, hi, wv = _bilinear_src(w, z.device)
    wv = wv.view(1, 1, w, 1)
    return _bf16r(zh[:, :, lo] * (1.0 - wv) + zh[:, :, hi] * wv)


def _check(rgb, ir, stacked, pos_emb, num_heads, gate):
    if rgb.shape != ir.shape or rgb.dim() != 4:
        raise ValueError(f"streams must share one (B, H, W, C) shape; got "
                         f"{tuple(rgb.shape)} and {tuple(ir.shape)}")
    b, h, w, c = rgb.shape
    if (min(b, h, w) < 1 or 2 * b > 65535 or c % 8 or c % num_heads
            or c // num_heads > 128):
        raise ValueError(f"merge kernel takes (B, H, W, C) with H, W >= 1, "
                         f"C % 8 == 0, C/heads at most 128 and B <= 32767; "
                         f"got {tuple(rgb.shape)} with {num_heads} heads")
    if tuple(pos_emb.shape[-2:]) != (TOKENS, c):
        raise ValueError(f"pos_emb has shape {tuple(pos_emb.shape)}, "
                         f"expected (1, {TOKENS}, {c})")
    L = stacked["wo"].shape[0]
    qkv = (("wqkv", (L, 3 * c, c)),) if "wqkv" in stacked else tuple(
        (k, (L, c, c)) for k in ("wq", "wk", "wv"))
    for k, shape in (*qkv, ("wo", (L, c, c)), ("w1", (L, 4 * c, c)),
                     ("w2", (L, c, 4 * c))):
        if tuple(stacked[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(stacked[k].shape)}, "
                             f"expected {shape}")
    if gate is not None and (tuple(gate["g1"].shape) != (c, 8)
                             or tuple(gate["g2"].shape) != (8, c)):
        raise ValueError(f"gate weights must be ({c}, 8) and (8, {c})")


def fused_gpt_merge_reference(rgb, ir, stacked: dict, pos_emb, lnf_scale,
                              lnf_bias, num_heads: int = 8,
                              gate: dict | None = None):
    """Plain PyTorch version of the kernel: two (B, H, W, C) streams ->
    the two merged streams, bf16."""
    _check(rgb, ir, stacked, pos_emb, num_heads, gate)
    b, h, w, c = rgb.shape
    bf16 = torch.bfloat16
    r32, i32 = rgb.to(bf16).float(), ir.to(bf16).float()
    tok = torch.cat([_pool8(r32), _pool8(i32)], 1)            # (B, 128, C)
    if gate is not None:
        m = _bf16r(torch.sigmoid(tok @ _bf16r(gate["g1"].float())))
        tok = _bf16r((m @ _bf16r(gate["g2"].float())) * tok)
    tok = (tok + pos_emb.float().reshape(1, TOKENS, c)).to(bf16)
    a = fused_token_transformer_reference(tok, stacked, num_heads)
    z = _bf16r(F.layer_norm(a.float(), (c,), lnf_scale.float(),
                            lnf_bias.float(), LN_EPS))
    n = GRID * GRID
    up_r = _upsample(z[:, :n].reshape(b, GRID, GRID, c), h, w)
    up_i = _upsample(z[:, n:].reshape(b, GRID, GRID, c), h, w)
    return (r32 + up_r).to(bf16), (i32 + up_i).to(bf16)


def _gpt_merge_cuda(rgb, ir, stack, pos_emb, lnf_scale, lnf_bias,
                    num_heads, g1, g2):
    """The op's CUDA implementation: one call of the kernel on the
    prepared weights (``STACK_KEYS`` order), counted."""
    b, h, w, c = rgb.shape
    dev = rgb.device
    bf16, f32 = torch.bfloat16, torch.float32
    ws = dict(zip(STACK_KEYS, stack))
    if any(t.device != dev for t in stack):
        raise ValueError(f"prepared weights must lie on {dev}, the streams' "
                         "device")
    ws = {k: t if t.is_contiguous() else t.contiguous()
          for k, t in ws.items()}
    L = ws["wo"].shape[0]
    rin = rgb.to(bf16).contiguous()  # (B, H, W, C) row-major
    iin = ir.to(dev, bf16).contiguous()
    pos = pos_emb.to(dev, f32).reshape(TOKENS, c).contiguous()
    lns = lnf_scale.to(dev, f32).contiguous()
    lnb = lnf_bias.to(dev, f32).contiguous()
    gated = g1 is not None
    if gated:
        g1 = g1.to(dev, bf16).contiguous()
        g2 = g2.to(dev, bf16).contiguous()
    else:
        g1 = g2 = pos  # never read
    rout, iout = torch.empty_like(rin), torch.empty_like(iin)
    m = b * TOKENS
    tok = torch.empty((m, c), dtype=bf16, device=dev)
    y, ctx = torch.empty_like(tok), torch.empty_like(tok)
    qkv = torch.empty((m, 3 * c), dtype=bf16, device=dev)
    hdn = torch.empty((m, 4 * c), dtype=bf16, device=dev)
    fn = kernels.load("gpt_merge")
    err = fn(rin.data_ptr(), iin.data_ptr(), rout.data_ptr(), iout.data_ptr(),
             pos.data_ptr(), g1.data_ptr(), g2.data_ptr(), lns.data_ptr(),
             lnb.data_ptr(), ws["ln1_scale"].data_ptr(),
             ws["ln1_bias"].data_ptr(), ws["wqkv"].data_ptr(),
             ws["bqkv"].data_ptr(), ws["wo"].data_ptr(), ws["bo"].data_ptr(),
             ws["ln2_scale"].data_ptr(), ws["ln2_bias"].data_ptr(),
             ws["w1"].data_ptr(), ws["b1"].data_ptr(), ws["w2"].data_ptr(),
             ws["b2"].data_ptr(), tok.data_ptr(), y.data_ptr(),
             qkv.data_ptr(), ctx.data_ptr(), hdn.data_ptr(), b, h, w, c, L,
             num_heads, int(gated),
             kernels.stream_ptr(rgb))
    kernels.check("gpt_merge", err)
    fused_gpt_merge.launches += 1
    return rout, iout


def _gpt_merge_cpu(rgb, ir, stack, pos_emb, lnf_scale, lnf_bias, num_heads,
                   g1, g2):
    gate = None if g1 is None else {"g1": g1, "g2": g2}
    return fused_gpt_merge_reference(rgb, ir, dict(zip(STACK_KEYS, stack)),
                                     pos_emb, lnf_scale, lnf_bias, num_heads,
                                     gate)


gpt_merge_op = torch.library.custom_op(
    f"{kernels.OPS}::fused_gpt_merge", _gpt_merge_cpu, mutates_args=(),
    device_types="cpu",
    schema="(Tensor rgb, Tensor ir, Tensor[] stack, Tensor pos_emb, "
           "Tensor lnf_scale, Tensor lnf_bias, int num_heads, Tensor? g1, "
           "Tensor? g2) -> (Tensor, Tensor)")
gpt_merge_op.register_kernel("cuda", _gpt_merge_cuda)


@gpt_merge_op.register_fake
def _(rgb, ir, stack, pos_emb, lnf_scale, lnf_bias, num_heads, g1, g2):
    return (rgb.new_empty(rgb.shape, dtype=torch.bfloat16),
            ir.new_empty(ir.shape, dtype=torch.bfloat16))


def fused_gpt_merge(rgb, ir, stacked: dict, pos_emb, lnf_scale, lnf_bias,
                    num_heads: int = 8, gate: dict | None = None):
    """(rgb + up(trans_rgb), ir + up(trans_ir)), both (B, H, W, C) bf16,
    through the op ``mmidet::fused_gpt_merge``.  On CUDA tensors this
    launches the kernel (one call; 5 launches plus K1's 7 per layer, its
    products on the TMA + wgmma GEMM, all on the current stream); on CPU
    tensors it runs the plain version.  The kernel reads and writes
    NHWC-contiguous memory, which the op makes so explicitly.
    ``stacked``: ``stack_block_params``' dict, or what ``prepare_stack``
    made of it."""
    if rgb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GPT-merge kernel for {rgb.device}")
    _check(rgb, ir, stacked, pos_emb, num_heads, gate)
    ws = prepare_stack(stacked, rgb.device)
    g1, g2 = (None, None) if gate is None else (gate["g1"], gate["g2"])
    return gpt_merge_op(rgb, ir, [ws[k] for k in STACK_KEYS], pos_emb,
                        lnf_scale, lnf_bias, num_heads, g1, g2)


fused_gpt_merge.launches = 0
