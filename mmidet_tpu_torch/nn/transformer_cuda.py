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

``layer_gemm`` runs the kernel's layer GEMM (TMA + wgmma, one of three
epilogues) alone, beside its plain version ``layer_gemm_reference``, so that
tests and ``chip_smoke.py`` can hold and time it product by product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mmidet_tpu_torch import kernels

TOKENS = 128  # 2 modalities x 8x8 grid
LN_EPS = 1e-5
# the layer GEMM's epilogues, as csrc/token_transformer.cuh numbers them
EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}
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


def prepare_stack(stacked: dict, device) -> dict[str, torch.Tensor]:
    """The buffers the kernels read, from stacked weights: matrices bf16,
    vectors f32, contiguous on ``device``, q/k/v joined into ``wqkv``
    ``(L, 3d, d)`` and ``bqkv`` ``(L, 3d)``.  A dict that already holds
    ``wqkv`` is taken as prepared, so a caller may keep the result between
    calls."""
    if "wqkv" in stacked:
        return stacked
    bf16, f32 = torch.bfloat16, torch.float32
    with torch.no_grad():
        ws = {k: t.to(device, f32 if k in _VECTORS else bf16).contiguous()
              for k, t in stacked.items()}
        ws["wqkv"] = torch.cat([ws.pop("wq"), ws.pop("wk"), ws.pop("wv")], 1)
        ws["bqkv"] = torch.cat([ws.pop("bq"), ws.pop("bk"), ws.pop("bv")], 1)
    return ws


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
    applied.  On a CUDA tensor this launches the kernel (one call; per
    layer 7 launches on the current stream: two LayerNorms, the attention
    and the four products on the TMA + wgmma GEMM); on a CPU tensor it runs
    the plain version.  ``stacked``: ``stack_block_params``' dict, or on a
    card what ``prepare_stack`` made of it."""
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
    bf16 = torch.bfloat16
    ws = prepare_stack(stacked, x.device)
    L = ws["wo"].shape[0]
    for k, shape in (("wqkv", (L, 3 * d, d)), ("wo", (L, d, d)),
                     ("w1", (L, 4 * d, d)), ("w2", (L, d, 4 * d)),
                     ("b1", (L, 4 * d))):
        if tuple(ws[k].shape) != shape or ws[k].device != x.device:
            raise ValueError(f"{k} has shape {tuple(ws[k].shape)} on "
                             f"{ws[k].device}, expected {shape} on "
                             f"{x.device}")
    xin = x.to(bf16).contiguous()
    out = torch.empty_like(xin)
    m = b * n
    y = torch.empty((m, d), dtype=bf16, device=x.device)
    ctx = torch.empty_like(y)
    qkv = torch.empty((m, 3 * d), dtype=bf16, device=x.device)
    hdn = torch.empty((m, 4 * d), dtype=bf16, device=x.device)
    fn = kernels.load("token_transformer")
    err = fn(xin.data_ptr(), out.data_ptr(), ws["ln1_scale"].data_ptr(),
             ws["ln1_bias"].data_ptr(), ws["wqkv"].data_ptr(),
             ws["bqkv"].data_ptr(), ws["wo"].data_ptr(), ws["bo"].data_ptr(),
             ws["ln2_scale"].data_ptr(), ws["ln2_bias"].data_ptr(),
             ws["w1"].data_ptr(), ws["b1"].data_ptr(), ws["w2"].data_ptr(),
             ws["b2"].data_ptr(), y.data_ptr(), qkv.data_ptr(),
             ctx.data_ptr(), hdn.data_ptr(), b, d, L, num_heads,
             kernels.stream_ptr(x))
    kernels.check("token_transformer", err)
    fused_token_transformer.launches += 1
    return out


fused_token_transformer.launches = 0


def layer_gemm_reference(a: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, epilogue: str,
                         residual: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Plain version of the layer GEMM: ``bf16(epilogue(a @ w^T + bias))``
    for a (M, K), w (N, K) (Linear layout), bias (N,).  The product runs in
    f32 on bf16-rounded operands and the bias is added in f32; ``gelu``
    applies erf-GELU, ``residual`` adds the bf16-rounded residual (M, N) in
    f32; the result is rounded to bf16 once."""
    bf16 = torch.bfloat16
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}")
    y = a.to(bf16).float() @ w.to(bf16).float().T + bias.float()
    if epilogue == "gelu":
        y = F.gelu(y)
    elif epilogue == "residual":
        y = residual.to(bf16).float() + y
    return y.to(bf16)


def layer_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               epilogue: str, residual: torch.Tensor | None = None
               ) -> torch.Tensor:
    """The layer GEMM alone: (M, N) bf16 = ``epilogue(a @ w^T + bias)``, as
    ``layer_gemm_reference`` computes it.  With ``epilogue="residual"`` the
    result overwrites ``residual`` (M, N) bf16 in place, as the layers
    update their tokens, and is returned.  On a CUDA tensor this launches
    the kernel (``tt_gemm``); on a CPU tensor it runs the plain version."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("a residual goes with the 'residual' epilogue, "
                         "and only with it")
    if a.device.type == "cpu":
        out = layer_gemm_reference(a, w, bias, epilogue, residual)
        return out if residual is None else residual.copy_(out)
    if a.device.type != "cuda":
        raise ValueError(f"no layer-GEMM kernel for {a.device}")
    bf16 = torch.bfloat16
    m, k = a.shape
    n = w.shape[0]
    if tuple(w.shape) != (n, k) or tuple(bias.shape) != (n,) or k % 8 \
            or n % 8:
        raise ValueError(f"kernel takes a (M, K), w (N, K), bias (N,) with "
                         f"N and K multiples of 8; got {tuple(a.shape)}, "
                         f"{tuple(w.shape)}, {tuple(bias.shape)}")
    a = a.to(bf16).contiguous()
    w = w.to(a.device, bf16).contiguous()
    bias = bias.to(a.device, torch.float32).contiguous()
    if residual is None:
        out = torch.empty((m, n), dtype=bf16, device=a.device)
    else:
        if (tuple(residual.shape) != (m, n) or residual.dtype != bf16
                or not residual.is_contiguous()
                or residual.device != a.device):
            raise ValueError(f"residual must be a contiguous ({m}, {n}) "
                             f"bf16 tensor on {a.device}")
        out = residual
    if any(t.data_ptr() % 16 for t in (a, w, bias, out)):
        raise ValueError("kernel takes 16-byte aligned operands")
    fn = kernels.load("layer_gemm")
    err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
             out.data_ptr(), m, n, k, EPILOGUES[epilogue],
             kernels.stream_ptr(a))
    kernels.check("layer_gemm", err)
    layer_gemm.launches += 1
    return out


layer_gemm.launches = 0
