"""P3, the CEM's lane-widened products: a hand-written CUDA kernel, its
plain PyTorch version and the probe's entry point.

Counterpart of ``tools/_probe_cem_fb.py``.  That probe asked whether the
TPU's compiler accepts the lane slices and concatenations that widen a row
before a product; the kernel (``csrc/cem_probes.cu``,
``lane_matmul_kernel``) computes what each of its bodies computes, bf16
operands with f32 sums:

    body         probe           row p of a (M, L)                   w
    slice192     _k_slice192     [a[168:], a, a[:24], 0^16]  (256)   (256, 128)
    slice8       _k_slice8       [a[7:8], a, a[0:1], 0^118]  (128)   (128, 128)
    ones_matmul  _k_ones_matmul  a (192)                             (192, 128)

    out (M, 128) f32 = p @ w

    python -m mmidet_tpu_torch.tools.probe_cem_fb

prints, per body, its largest error against the plain version and its
times, on the card (M = 96, the probe's shapes).
"""

from __future__ import annotations

import json

import torch

from mmidet_tpu_torch import kernels

M = 96
BODIES = ("slice192", "slice8", "ones_matmul")
WIDTH = {"slice192": (192, 256), "slice8": (8, 128), "ones_matmul": (192, 192)}
# f32 sums of exact bf16 products in another order: 1e-5 of max |plain|
TOL = 1e-5


def _check(body: str, a, w) -> None:
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}; got {body!r}")
    lanes, k = WIDTH[body]
    if a.dim() != 2 or a.shape[1] != lanes or tuple(w.shape) != (k, 128):
        raise ValueError(f"{body} takes a (M, {lanes}) and w ({k}, 128); "
                         f"got {tuple(a.shape)}, {tuple(w.shape)}")


def widen(body: str, a):
    """The rows the product reads: a's lanes wrapped and zero-padded."""
    if body == "slice192":
        return torch.cat([a[:, 168:], a, a[:, :24], a.new_zeros(len(a), 16)],
                         1)
    if body == "slice8":
        return torch.cat([a[:, 7:8], a, a[:, 0:1], a.new_zeros(len(a), 118)],
                         1)
    return a


def lane_matmul_reference(body: str, a, w):
    """Plain PyTorch version: the widened rows times w in f32."""
    _check(body, a, w)
    return widen(body, a.float()) @ w.float()


def lane_matmul(body: str, a, w):
    """``body``'s (M, 128) f32 output.  On a CUDA tensor this launches the
    kernel (one launch); on a CPU tensor it runs the plain version."""
    if a.device.type == "cpu":
        return lane_matmul_reference(body, a, w)
    if a.device.type != "cuda":
        raise ValueError(f"no lane-matmul kernel for {a.device}")
    _check(body, a, w)
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"lane-matmul kernel takes bf16; got {a.dtype}, "
                         f"{w.dtype}")
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty(len(a), 128, dtype=torch.float32, device=a.device)
    fn = kernels.load("lane_matmul")
    kernels.check("lane_matmul", fn(a.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), BODIES.index(body),
                                    len(a), kernels.stream_ptr(a)))
    lane_matmul.launches += 1
    return out


lane_matmul.launches = 0


def inputs(body: str, device, seed: int = 0):
    """Seeded operands as the probe makes them: normal bf16 a and w; for
    ``ones_matmul`` the selector that sums each 24 lanes of a 192-lane row
    into one of 8 columns (the other 120 zero)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes, k = WIDTH[body]
    a = torch.randn(M, lanes, generator=gen, device=device).to(torch.bfloat16)
    if body == "ones_matmul":
        w = torch.zeros(k, 128, device=device, dtype=torch.bfloat16)
        w[torch.arange(k, device=device),
          torch.arange(k, device=device) // 24] = 1
    else:
        w = torch.randn(k, 128, generator=gen, device=device).to(
            torch.bfloat16)
    return a, w


def main(device: str = "cuda") -> list[dict]:
    """Each body on seeded input against its plain version, with its times
    on a CUDA device.  Prints one line per body; returns the records."""
    from mmidet_tpu_torch.tools.timing import PEAK_BF16_FLOPS, timed
    recs = []
    for body in BODIES:
        a, w = inputs(body, device)
        got, want = lane_matmul(body, a, w), lane_matmul_reference(body, a, w)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        rec = {"body": body, "max_abs_err": err, "max_abs_ref": top,
               "tol": TOL * top, "ok": err <= TOL * top}
        if not rec["ok"]:
            raise AssertionError(f"lane-matmul kernel disagrees with its "
                                 f"plain version on {body}: {rec}")
        if device != "cpu":
            # the product's operations at its padded width, as the body
            # runs it; a, w read once, the output written once
            k = WIDTH[body][1]
            rec.update(timed(
                lambda: lane_matmul(body, a, w),
                lambda: lane_matmul_reference(body, a, w),
                # cuBLAS on the widened rows: one call for ones_matmul only
                (lambda: torch.matmul(a, w)) if body == "ones_matmul"
                else None, 2 * len(a) * k * 128,
                a.numel() * 2 + w.numel() * 2 + got.numel() * 4,
                PEAK_BF16_FLOPS))
        print(json.dumps({"probe": "cem_fb", **rec}), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
