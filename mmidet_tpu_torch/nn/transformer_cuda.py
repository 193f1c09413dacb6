"""The fused token transformer: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``mmidet_tpu/nn/transformer_pallas.py``.  The kernel
(``csrc/token_transformer.cu``) replaces the TPU kernel
``fused_token_transformer`` there: an L-layer pre-LN transformer over the
128 tokens (2 modalities x 8x8) of one fusion level, ``ln_f`` left to the
caller.  Both versions here round where the Pallas kernel rounds
(``transformer_pallas.py:93-144``): LN output, q/k/v, P, the context, each
residual sum and the GELU output are bf16; statistics, softmax, GELU and
every accumulation are f32.

Stacked weights use torch's Linear layout, ``(L, out, in)``; the dict keys
are the JAX package's (``ln1_scale`` .. ``b2``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mmidet_tpu_torch import kernels

TOKENS = 128  # 2 modalities x 8x8 grid
LN_EPS = 1e-5
_VECTORS = ("ln1_scale", "ln1_bias", "bq", "bk", "bv", "bo", "ln2_scale",
            "ln2_bias", "b1", "b2")


def stack_block_params(blocks) -> dict[str, torch.Tensor]:
    """Stack the weights of a list of ``PreLNBlock`` modules into the
    per-layer arrays the kernel takes (``transformer_pallas.py:307-330``)."""
    def st(fn):
        return torch.stack([fn(b) for b in blocks])

    out = {
        "ln1_scale": st(lambda b: b.ln_input.weight),
        "ln1_bias": st(lambda b: b.ln_input.bias),
        "ln2_scale": st(lambda b: b.ln_output.weight),
        "ln2_bias": st(lambda b: b.ln_output.bias),
        "wo": st(lambda b: b.sa.out_proj.weight),
        "bo": st(lambda b: b.sa.out_proj.bias),
        "w1": st(lambda b: b.mlp[0].weight),
        "b1": st(lambda b: b.mlp[0].bias),
        "w2": st(lambda b: b.mlp[2].weight),
        "b2": st(lambda b: b.mlp[2].bias),
    }
    for w, bias, nm in (("wq", "bq", "que_proj"), ("wk", "bk", "key_proj"),
                        ("wv", "bv", "val_proj")):
        out[w] = st(lambda blk, nm=nm: getattr(blk.sa, nm).weight)
        out[bias] = st(lambda blk, nm=nm: getattr(blk.sa, nm).bias)
    return out


def fused_token_transformer_reference(x: torch.Tensor, stacked: dict,
                                      num_heads: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, 128, d) -> (B, 128, d)
    bf16.  Products run in f32 on bf16-rounded operands, which is what the
    tensor cores compute up to the order of the f32 sums."""
    b, n, d = x.shape
    dk = d // num_heads
    inv = 1.0 / math.sqrt(dk)
    bf16 = torch.bfloat16
    L = stacked["wq"].shape[0]

    def w(name, l):
        return stacked[name][l].to(bf16).float()

    def v(name, l):
        return stacked[name][l].float()

    a = x.to(bf16)
    for l in range(L):
        y = F.layer_norm(a.float(), (d,), v("ln1_scale", l),
                         v("ln1_bias", l), LN_EPS).to(bf16).float()
        q, k, val = ((y @ w(wn, l).T + v(bn, l)).to(bf16).float()
                     .view(b, n, num_heads, dk).transpose(1, 2)
                     for wn, bn in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        p = torch.softmax((q @ k.transpose(-1, -2)) * inv, -1).to(bf16)
        ctx = (p.float() @ val).transpose(1, 2).reshape(b, n, d).to(bf16)
        a = (a.float() + (ctx.float() @ w("wo", l).T + v("bo", l))).to(bf16)
        y = F.layer_norm(a.float(), (d,), v("ln2_scale", l),
                         v("ln2_bias", l), LN_EPS).to(bf16).float()
        hdn = F.gelu(y @ w("w1", l).T + v("b1", l)).to(bf16).float()
        a = (a.float() + (hdn @ w("w2", l).T + v("b2", l))).to(bf16)
    return a


def fused_token_transformer(x: torch.Tensor, stacked: dict,
                            num_heads: int = 8) -> torch.Tensor:
    """(B, 128, d) tokens, pos-emb added -> (B, 128, d) bf16, ``ln_f`` not
    applied.  On a CUDA tensor this launches the kernel (one call, 7
    launches per layer, all on the current stream); on a CPU tensor it runs
    the plain version."""
    if x.device.type == "cpu":
        return fused_token_transformer_reference(x, stacked, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"no token-transformer kernel for {x.device}")
    b, n, d = x.shape
    dk = d // num_heads
    if n != TOKENS or d % 8 or d % num_heads or dk > 128:
        raise ValueError(f"kernel takes (B, {TOKENS}, d) with d % 8 == 0 "
                         f"and d/heads at most 128; got {tuple(x.shape)} "
                         f"with {num_heads} heads")
    L = stacked["wq"].shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    ws = {k: t.to(x.device, f32 if k in _VECTORS else bf16).contiguous()
          for k, t in stacked.items()}
    for k, shape in (("wo", (L, d, d)), ("w1", (L, 4 * d, d)),
                     ("w2", (L, d, 4 * d)), ("b1", (L, 4 * d))):
        if tuple(ws[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(ws[k].shape)}, "
                             f"expected {shape}")
    wqkv = torch.cat([ws["wq"], ws["wk"], ws["wv"]], 1).contiguous()
    bqkv = torch.cat([ws["bq"], ws["bk"], ws["bv"]], 1).contiguous()
    xin = x.to(bf16).contiguous()
    out = torch.empty_like(xin)
    m = b * n
    y = torch.empty((m, d), dtype=bf16, device=x.device)
    ctx = torch.empty_like(y)
    qkv = torch.empty((m, 3 * d), dtype=bf16, device=x.device)
    hdn = torch.empty((m, 4 * d), dtype=bf16, device=x.device)
    fn = kernels.load("token_transformer")
    err = fn(xin.data_ptr(), out.data_ptr(), ws["ln1_scale"].data_ptr(),
             ws["ln1_bias"].data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
             ws["wo"].data_ptr(), ws["bo"].data_ptr(),
             ws["ln2_scale"].data_ptr(), ws["ln2_bias"].data_ptr(),
             ws["w1"].data_ptr(), ws["b1"].data_ptr(), ws["w2"].data_ptr(),
             ws["b2"].data_ptr(), y.data_ptr(), qkv.data_ptr(),
             ctx.data_ptr(), hdn.data_ptr(), b, d, L, num_heads,
             kernels.stream_ptr(x))
    kernels.check("token_transformer", err)
    fused_token_transformer.launches += 1
    return out


fused_token_transformer.launches = 0
