"""P1, a stage's conv chain: a hand-written CUDA kernel, its plain PyTorch
version and the probe's entry point.

Counterpart of ``tools/_probe_igemm.py``.  The kernel (``csrc/conv_chain.cu``)
replaces its TPU kernel ``make_chain_kernel`` (driven by ``pallas_chain``)
and both versions compute its ``xla_chain``, per image

    y = bf16(silu(conv3x3_same(x, w1)))     # bf16 operands, f32 sums
    z = bf16(silu(conv3x3_same(y, w2)))

on NHWC bf16 ``x (B, H, W, C)`` with HWIO weights ``(3, 3, C, C)``, no
bias.  The kernel keeps ``y`` in shared memory.

    python -m mmidet_tpu_torch.tools.probe_igemm [batch] [hw] [C]

checks the kernel against the plain version at 2x32x32 and at the given
size, then times kernel, plain version and cuDNN (bf16, channels-last,
``F.conv2d`` + ``F.silu`` twice), for C and for the C = 128 arm, on the
card (defaults: 128 160 64, the probe's own).
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch
import torch.nn.functional as F

from mmidet_tpu_torch import kernels

CHANNELS = (64, 128)
# max |kernel - plain| <= 2% of max |plain|: the two round y to bf16 at the
# same point, but a sum in another order can flip one rounding of y (2^-8
# relative), which conv2 spreads over nine taps x C channels
TOL = 0.02


def _check(x, w1, w2) -> None:
    if x.dim() != 4 or x.shape[-1] not in CHANNELS:
        raise ValueError(f"conv chain takes (B, H, W, C) with C in "
                         f"{CHANNELS}; got {tuple(x.shape)}")
    c = x.shape[-1]
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (3, 3, c, c):
            raise ValueError(f"{name} has shape {tuple(w.shape)}, expected "
                             f"{(3, 3, c, c)}")


def conv_chain_reference(x, w1, w2) -> torch.Tensor:
    """Plain PyTorch version: f32 convolutions (TF32 off) on bf16 values,
    SiLU in f32, bf16 after each conv.  Returns (B, H, W, C) bf16."""
    _check(x, w1, w2)

    def conv(a, w):
        return F.conv2d(a, w.to(torch.bfloat16).float().permute(3, 2, 0, 1),
                        padding=1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        a = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        y = F.silu(conv(a, w1)).to(torch.bfloat16).float()
        z = F.silu(conv(y, w2)).to(torch.bfloat16)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return z.permute(0, 2, 3, 1).contiguous()


def prepare_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, C) -> the kernel's (9, C, C) bf16, [tap][co][ci]."""
    c = w.shape[-1]
    return w.detach().to(torch.bfloat16).reshape(9, c, c).transpose(
        1, 2).contiguous()


def conv_chain(x, w1, w2, prepared=None) -> torch.Tensor:
    """The chain's output (B, H, W, C) bf16.  On a CUDA tensor this
    launches the kernel (one launch); on a CPU tensor it runs the plain
    version.  ``prepared``: ``(prepare_weights(w1), prepare_weights(w2))``
    from a caller that keeps them between calls."""
    if x.device.type == "cpu":
        return conv_chain_reference(x, w1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"no conv-chain kernel for {x.device}")
    _check(x, w1, w2)
    b, h, w, c = x.shape
    check_launch(b, h, w)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv-chain kernel takes bf16; got {x.dtype}")
    xin = x.contiguous()
    if xin.data_ptr() % 16:  # the kernel loads 16-byte chunks
        xin = xin.clone()
    p1, p2 = prepared if prepared is not None else (
        prepare_weights(w1.to(x.device)), prepare_weights(w2.to(x.device)))
    for p in (p1, p2):
        if (tuple(p.shape) != (9, c, c) or p.dtype != torch.bfloat16
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"prepared weights must be contiguous (9, {c}, "
                             f"{c}) bf16 on {x.device}")
    out = torch.empty_like(xin)
    fn = kernels.load("conv_chain")
    kernels.check("conv_chain", fn(xin.data_ptr(), p1.data_ptr(),
                                   p2.data_ptr(), out.data_ptr(), b, h, w, c,
                                   kernels.stream_ptr(x)))
    conv_chain.launches += 1
    return out


conv_chain.launches = 0


TILE = 16          # the kernel's output tile: TILE x TILE pixels
MAX_TILES = 2 ** 31 - 1


def tiles(b: int, h: int, w: int) -> int:
    """The kernel's 16 x 16 output tiles for (B, H, W); its persistent
    blocks walk them in the order (image, tile row, tile column)."""
    return b * -(-h // TILE) * -(-w // TILE)


def check_launch(b: int, h: int, w: int) -> None:
    """Raise unless the kernel takes (B, H, W): each at least 1 (any batch:
    the persistent grid does not grow with B) and fewer than 2^31 tiles."""
    if min(b, h, w) < 1:
        raise ValueError(f"conv chain takes B, H, W >= 1; got {(b, h, w)}")
    if tiles(b, h, w) > MAX_TILES:
        raise ValueError(f"conv chain takes at most {MAX_TILES} tiles of "
                         f"{TILE}x{TILE}; got {tiles(b, h, w)} for "
                         f"{(b, h, w)}")


def launch_config(b: int, h: int, w: int, c: int) -> dict:
    """The kernel's launch for (B, H, W, C), from its own source (on the
    card): persistent blocks, tiles, shared-memory bytes a block, weight
    stages in the ring, input buffers."""
    cfg = (ctypes.c_int * 5)()
    kernels.check("conv_chain_config", kernels.load("conv_chain_config")(
        b, h, w, c, ctypes.addressof(cfg)))
    return dict(zip(("blocks", "tiles", "smem_bytes", "ring_stages",
                     "input_buffers"), cfg))


def library_chain(x_cl, w1_cl, w2_cl) -> torch.Tensor:
    """The same chain from cuDNN in bf16 on channels-last NCHW views: a
    yardstick for the kernel's time, never called by the port.  cuDNN
    rounds each conv's output to bf16 before SiLU, so it is no reference."""
    return F.silu(F.conv2d(F.silu(F.conv2d(x_cl, w1_cl, padding=1)), w2_cl,
                           padding=1))


def chain_work(b: int, h: int, w: int, c: int):
    """Operations and bytes of one call: two convs of 2 * 9 * C * C per
    output pixel; the input read and the output written once (bf16), the
    weights read once."""
    return (2 * 2 * 9 * c * c * b * h * w,
            2 * b * h * w * c * 2 + 2 * 9 * c * c * 2)


def inputs(b: int, h: int, w: int, c: int, device, seed: int = 0):
    """Seeded x (B, H, W, C) bf16 and HWIO weights (normal * 0.05) in bf16,
    as the probe makes them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen, device=device).to(
        torch.bfloat16)
    w1, w2 = ((0.05 * torch.randn(3, 3, c, c, generator=gen, device=device))
              .to(torch.bfloat16) for _ in range(2))
    return x, w1, w2


def check(b: int, h: int, w: int, c: int, device, seed: int = 0) -> dict:
    """Kernel (on a CUDA device) against the plain version on seeded
    inputs of (b, h, w, c); raises past ``TOL``."""
    x, w1, w2 = inputs(b, h, w, c, device, seed)
    got = conv_chain(x, w1, w2).float()
    want = conv_chain_reference(x, w1, w2).float()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    rec = {"shape": [b, h, w, c], "max_abs_err": err, "max_abs_ref": top,
           "tol": TOL, "ok": err <= TOL * top}
    if not rec["ok"]:
        raise AssertionError(f"conv chain kernel disagrees with its plain "
                             f"version at {rec['shape']}: {err} at |ref| "
                             f"{top}")
    return rec


def measure(b: int, hw: int, c: int, device) -> dict:
    """Kernel against plain version at the given size, and the times of
    kernel, plain version and cuDNN, beside the bound.  The last timed
    launch's output must equal the first's bit for bit (the kernel is
    deterministic: a race shows as a difference between launches)."""
    from mmidet_tpu_torch.tools.timing import PEAK_BF16_FLOPS, timed
    x, w1, w2 = inputs(b, hw, hw, c, device)
    prep = (prepare_weights(w1), prepare_weights(w2))
    want = conv_chain_reference(x, w1, w2).float()
    top = float(want.abs().max())
    first = conv_chain(x, w1, w2, prep)
    err = float((first.float() - want).abs().max())
    x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    w1_cl, w2_cl = (w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for w in (w1, w2))
    lib_err = float((library_chain(x_cl, w1_cl, w2_cl).permute(0, 2, 3, 1)
                     .float() - want).abs().max())
    del want
    if err > TOL * top:
        raise AssertionError(f"conv chain kernel disagrees with its plain "
                             f"version at {b}x{hw}x{hw}x{c}: {err} at |ref| "
                             f"{top}")
    flops, nbytes = chain_work(b, hw, hw, c)
    last = [first]

    def run():
        last[0] = conv_chain(x, w1, w2, prep)
    rec = {"batch": b, "hw": hw, "c": c, "max_abs_err": err,
           "max_abs_ref": top, "tol": TOL, "ok": True,
           "library_max_abs_err": lib_err, "gflop": flops / 1e9,
           "mbytes": nbytes / 1e6,
           **timed(run, lambda: conv_chain_reference(x, w1, w2),
                   lambda: library_chain(x_cl, w1_cl, w2_cl), flops, nbytes,
                   PEAK_BF16_FLOPS, plain_reps=3)}
    if last[0] is first or not torch.equal(last[0], first):
        raise AssertionError(f"conv chain kernel gave another output on a "
                             f"later launch at {b}x{hw}x{hw}x{c}")
    rec["repeat_identical"] = True
    rec["tflops"] = flops / rec["ms"] / 1e9
    rec["device_tflops"] = flops / rec["device_ms"] / 1e9
    rec["library_tflops"] = flops / rec["library_ms"] / 1e9
    rec["launch"] = launch_config(b, hw, hw, c)
    rec["ptxas"] = kernels.ptxas_report("conv_chain")
    return rec


def main(argv=None, device: str = "cuda") -> list[dict]:
    """The probe's run: per arm (C, then C = 128) the kernel against the
    plain version at 2x32x32, then at the given size with its times.  On
    ``device="cpu"`` only the plain version runs, at 2x32x32.  Prints one
    line per arm and returns the records."""
    argv = sys.argv[1:] if argv is None else argv
    b = int(argv[0]) if len(argv) > 0 else 128
    hw = int(argv[1]) if len(argv) > 1 else 160
    c = int(argv[2]) if len(argv) > 2 else 64
    recs = []
    for arm in dict.fromkeys((c, 128)):
        if device == "cpu":
            x, w1, w2 = inputs(2, 32, 32, arm, device)
            out = conv_chain(x, w1, w2)
            rec = {"c": arm, "shape": list(out.shape),
                   "finite": bool(torch.isfinite(out.float()).all())}
            print(f"C={arm}: plain version only on the CPU {rec}")
        else:
            rec = {"small": check(2, 32, 32, arm, device),
                   **measure(b, hw, arm, device)}
            print(json.dumps({"probe": "igemm", **rec}), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
