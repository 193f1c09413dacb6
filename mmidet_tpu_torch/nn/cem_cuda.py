"""The fused CEM: a hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``mmidet_tpu/nn/cem_pallas.py``.  The kernel
(``csrc/cem.cu``) replaces the TPU kernel ``fused_cem`` there: the whole
BN-folded Contour Enhancement Module in one pass,

    y   = leaky_0.1(conv2(x) + b2)          # 3x3, 3 -> 24
    e   = tile3(bank8 (*) sum_c y) * factor + bias_s
    z   = leaky_0.1(conv3(y + e) + b3)      # 3x3, 24 -> 3
    out = z + x

Public layout is the JAX function's: x ``(B, H, W, 3)`` NHWC, conv kernels
HWIO (``w2 (3, 3, 3, 24)``, ``w3 (3, 3, 24, 3)``), vectors ``(24,)``/``(3,)``.
A bf16 ``x`` takes the bf16 form of the Pallas kernel, an f32 ``x`` its
``precise=True`` form.  Both versions here round where the Pallas kernel
rounds in bf16 (``cem_pallas.py:171-243, 318``): w2, ``bank * factor`` and w3
to bf16; y, its channel sum, ``y + e``, z and ``z + x`` to bf16; every sum
and both leaky-ReLUs in f32.  In f32 nothing is rounded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmidet_tpu_torch import kernels
from mmidet_tpu_torch.nn.cem import edge_filter_bank

_E = 24  # expanded channels = 8 * 3
# offsets (floats) into the packed weight buffer, as csrc/cem.cu reads it
_OFF_W2, _OFF_WB, _OFF_W3, _OFF_B2, _OFF_BS, _OFF_B3, _PACK = (
    0, 672, 960, 1608, 1632, 1656, 1660)


def _check_x(x) -> None:
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused CEM takes (B, H, W, 3); got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused CEM takes bf16 or f32; got {x.dtype}")


def _check_params(x, w2, b2, factor, bias_s, w3, b3) -> None:
    _check_x(x)
    for name, t, shape in (("w2", w2, (3, 3, 3, _E)), ("b2", b2, (_E,)),
                           ("factor", factor, (_E,)),
                           ("bias_s", bias_s, (_E,)),
                           ("w3", w3, (3, 3, _E, 3)), ("b3", b3, (3,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _rounder(dtype):
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def _bank_weight(factor: torch.Tensor, rnd) -> torch.Tensor:
    """(3, 3, 24): ``bank8[.., m % 8] * factor[m]``, the tile and the scale
    folded into the bank (``cem_pallas.py:130-131``), then rounded."""
    bank8 = torch.from_numpy(edge_filter_bank(8, 1, 3)[:, :, 0, :]).to(
        factor.device)
    return rnd(bank8.repeat(1, 1, _E // 8) * factor.float())


def fused_cem_reference(x, w2, b2, factor, bias_s, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (B, H, W, 3) -> the same in
    ``x.dtype``.  The convolutions run in true f32 (TF32 off) on operands
    rounded as the kernel rounds them; zero padding of ``y`` and ``y + e``
    is the convolutions' own."""
    _check_params(x, w2, b2, factor, bias_s, w3, b3)
    rnd = _rounder(x.dtype)
    xf = x.float().permute(0, 3, 1, 2)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xf, rnd(w2.float()).permute(3, 2, 0, 1), b2.float(),
                     padding=1)
        y = rnd(F.leaky_relu(y, 0.1))
        s = rnd(y.sum(1, keepdim=True))
        wb = _bank_weight(factor, rnd).permute(2, 0, 1)[:, None]
        e = F.conv2d(s, wb, bias_s.float(), padding=1)
        y2 = rnd(y + e)
        z = F.conv2d(y2, rnd(w3.float()).permute(3, 2, 0, 1), b3.float(),
                     padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    z = rnd(F.leaky_relu(z, 0.1))
    return (z + xf).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def pack_cem_weights(w2, b2, factor, bias_s, w3, b3,
                     dtype: torch.dtype) -> torch.Tensor:
    """The kernel's one weight buffer (1660 floats): w2 as [24][27 + 1] with
    taps in (ky, kx, c) order, ``bank * factor`` as [24][9 + 3], w3 as
    [9][24][3], then b2, bias_s, b3.  Matrices are rounded to ``dtype``
    here, so that the kernel reads f32 values in either form."""
    rnd = _rounder(dtype)
    dev = w2.device
    w2, b2, factor, bias_s, w3, b3 = (
        t.detach() for t in (w2, b2, factor, bias_s, w3, b3))
    pack = torch.zeros(_PACK, dtype=torch.float32, device=dev)
    w2p = torch.zeros(_E, 28, dtype=torch.float32, device=dev)
    w2p[:, :27] = rnd(w2.float()).reshape(27, _E).T
    wbp = torch.zeros(_E, 12, dtype=torch.float32, device=dev)
    wbp[:, :9] = _bank_weight(factor, rnd).reshape(9, _E).T
    pack[_OFF_W2:_OFF_WB] = w2p.reshape(-1)
    pack[_OFF_WB:_OFF_W3] = wbp.reshape(-1)
    pack[_OFF_W3:_OFF_B2] = rnd(w3.float()).reshape(-1)
    pack[_OFF_B2:_OFF_BS] = b2.float()
    pack[_OFF_BS:_OFF_B3] = bias_s.float()
    pack[_OFF_B3:_OFF_B3 + 3] = b3.float()
    return pack


def fused_cem(x, w2, b2, factor, bias_s, w3, b3,
              pack: torch.Tensor | None = None) -> torch.Tensor:
    """The CEM output (B, H, W, 3) in ``x.dtype``.  On a CUDA tensor this
    launches the kernel (one launch on the current stream); on a CPU tensor
    it runs the plain version.  The kernel reads and writes NHWC-contiguous
    memory, which the wrapper makes so explicitly.  ``pack``: the result of
    ``pack_cem_weights`` for these weights and ``x.dtype`` on ``x.device``,
    from a caller that keeps it between calls; packed here otherwise (a
    dozen small launches)."""
    if x.device.type == "cpu":
        return fused_cem_reference(x, w2, b2, factor, bias_s, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"no CEM kernel for {x.device}")
    if pack is None:
        _check_params(x, w2, b2, factor, bias_s, w3, b3)
    else:  # the kernel reads the weights from the pack alone
        _check_x(x)
    b, h, w, _ = x.shape
    if min(b, h, w) < 1 or b > 65535:
        raise ValueError(f"CEM kernel takes 1 <= B <= 65535 and H, W >= 1; "
                         f"got {tuple(x.shape)}")
    xin = x.contiguous()  # (B, H, W, 3) row-major: channels innermost
    if xin.data_ptr() % 16:  # the kernel reads x in aligned 16-byte chunks
        xin = xin.clone()
    if pack is None:
        pack = pack_cem_weights(*(t.to(x.device) for t in (
            w2, b2, factor, bias_s, w3, b3)), x.dtype)
    elif (tuple(pack.shape) != (_PACK,) or pack.dtype != torch.float32
          or pack.device != x.device or not pack.is_contiguous()):
        raise ValueError(f"pack must be {_PACK} contiguous f32 values on "
                         f"{x.device}")
    out = torch.empty_like(xin)
    fn = kernels.load("cem")
    err = fn(xin.data_ptr(), pack.data_ptr(), out.data_ptr(), b, h, w,
             int(x.dtype == torch.bfloat16), kernels.stream_ptr(x))
    kernels.check("cem", err)
    fused_cem.launches += 1
    return out


fused_cem.launches = 0
