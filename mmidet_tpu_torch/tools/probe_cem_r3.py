"""P2, the CEM's halo-gather sums: a hand-written CUDA kernel, its plain
PyTorch version and the probe's entry point.

Counterpart of ``tools/_probe_cem_r3.py``.  That probe asked which of four
ways to gather a pixel's halo the TPU's compiler accepts; the kernel
(``csrc/cem_probes.cu``, ``halo_sum_kernel``) computes what each of its
bodies computes, at its shapes and rounding points: per output pixel the
f32 sum of the gathered bf16 values, rounded once to bf16, on all 8 lanes
of an f32 output.

    body         probe   input (bf16)          output (f32)
    halo_concat  _k_a    (R+4, G+2, 8)         (R+2, G, 8)
    halo_roll    _k_b    (R+4, G, 8)           (R+2, G, 8)
    lane_wrap    _k_c    (R+2, G, 192)         (R+2, G, 8)
    flat_gather  _k_d    ((R+4)(G+2), 8)       ((R+2) G, 8)

    python -m mmidet_tpu_torch.tools.probe_cem_r3

prints, per body, its largest error against the plain version and its
times on the card (R = G = 80, the probe's shapes), beside one PyTorch
call of the same sums (``library_call``) and an empty launch (the floor).
"""

from __future__ import annotations

import functools
import json

import torch
import torch.nn.functional as F

from mmidet_tpu_torch import kernels

R = G = 80
BODIES = ("halo_concat", "halo_roll", "lane_wrap", "flat_gather")
# the f32 sums differ only in order, which can flip the one bf16 rounding:
# one bf16 step, 2^-8 of max(1, |value|)
TOL = 2.0 ** -8


@functools.lru_cache(maxsize=64)
def shapes(body: str, r: int = R, g: int = G):
    """(input shape, output shape) of ``body``, computed once per (body, r,
    g)."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}; got {body!r}")
    return {"halo_concat": ((r + 4, g + 2, 8), (r + 2, g, 8)),
            "halo_roll": ((r + 4, g, 8), (r + 2, g, 8)),
            "lane_wrap": ((r + 2, g, 192), (r + 2, g, 8)),
            "flat_gather": (((r + 4) * (g + 2), 8), ((r + 2) * g, 8))}[body]


def work(body: str, r: int = R, g: int = G) -> tuple[int, int]:
    """(adds, bytes) that ``body``'s sums need, for its bound: the input
    values that some sum reads (halo_concat and halo_roll: rows 2.. of t,
    halo_concat's pad pixels only for one lane each; flat_gather: lane 0
    of the flat rows that a window reaches) read once as bf16, one add
    fewer than values a sum, the f32 output written once."""
    n = (r + 2) * g
    taps, read = {"halo_concat": (10, (r + 2) * (8 * g + 2)),
                  "halo_roll": (10, n * 8),
                  "lane_wrap": (240, n * 192),
                  "flat_gather": (9, n + 2 * (g + 2) + 2)}[body]
    return n * (taps - 1), read * 2 + n * 8 * 4


def _check(body: str, t, r: int, g: int) -> None:
    want = shapes(body, r, g)[0]
    if t.shape != want:
        raise ValueError(f"{body} takes {want}; got {tuple(t.shape)}")


def lane_wrap_weights() -> torch.Tensor:
    """``lane_wrap``'s sum as one weighted sum over a pixel's 192 lanes:
    lanes [0:24) and [168:192) are read twice, the rest once (the kernel's
    8 threads a pixel weight their 16-byte chunks so)."""
    w = torch.ones(192)
    w[:24] = w[168:] = 2
    return w


def halo_sum_reference(body: str, t, r: int = R, g: int = G):
    """Plain PyTorch version: gather, f32 sum, bf16, 8 lanes of f32."""
    _check(body, t, r, g)
    x = t.float()
    if body == "halo_concat":
        p = torch.cat([x[2:, 0:g, 7:8], x[2:, 1:g + 1], x[2:, 2:g + 2, 0:1]],
                      -1)
    elif body == "halo_roll":
        zero = x.new_zeros(r + 2, 1, 1)
        p = torch.cat([torch.cat([zero, x[2:, :g - 1, 7:8]], 1), x[2:],
                       torch.cat([x[2:, 1:, 0:1], zero], 1)], -1)
    elif body == "lane_wrap":
        p = torch.cat([x[..., 168:], x, x[..., :24]], -1)
    else:
        n = (r + 2) * g
        p = torch.cat([x[dy * (g + 2) + dg:dy * (g + 2) + dg + n, :1]
                       for dy in range(3) for dg in range(3)], -1)
    s = p.sum(-1, keepdim=True).to(torch.bfloat16).float()
    return s.expand(*s.shape[:-1], 8).contiguous()


def halo_sum(body: str, t, r: int = R, g: int = G, out=None):
    """``body``'s output, written into ``out`` when given (a contiguous f32
    tensor of the output's shape on t's device).  On a CUDA tensor this
    launches the kernel (one launch); on a CPU tensor it runs the plain
    version."""
    if t.device.type == "cpu":
        got = halo_sum_reference(body, t, r, g)
        if out is None:
            return got
        kernels.check_out(out, got.shape, torch.float32, t.device)
        return out.copy_(got)
    if t.device.type != "cuda":
        raise ValueError(f"no halo-sum kernel for {t.device}")
    _check(body, t, r, g)
    if t.dtype != torch.bfloat16:
        raise ValueError(f"halo-sum kernel takes bf16; got {t.dtype}")
    t = kernels.aligned(t)
    shape = shapes(body, r, g)[1]
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=t.device)
    else:
        kernels.check_out(out, shape, torch.float32, t.device)
    kernels.check("halo_sum", kernels.load("halo_sum")(
        t.data_ptr(), out.data_ptr(), BODIES.index(body), r, g,
        kernels.stream_ptr(t)))
    halo_sum.launches += 1
    return out


halo_sum.launches = 0


def library_call(body: str, t, r: int = R, g: int = G):
    """One PyTorch call of ``body``'s sums, as a function of no arguments
    whose result, flattened, is the (r + 2) g sums in bf16, without the
    widening to 8 lanes; its weights are made here, outside the call.
    halo_concat and halo_roll: a 10-tap convolution of stride 8 over each
    row's lanes; lane_wrap: the rows times ``lane_wrap_weights``;
    flat_gather: a 167-tap convolution over lane 0 with 9 taps of one
    (18x the multiplies the sums need)."""
    if body in ("halo_concat", "halo_roll"):
        ones = t.new_ones(1, 1, 10)
        pad = 0 if body == "halo_concat" else 1
        rows = t[2:].reshape(r + 2, 1, -1)
        if body == "halo_concat":
            rows = rows[..., 7:]  # from lane 7 of pixel 0
        return lambda: F.conv1d(rows, ones, stride=8, padding=pad)
    if body == "lane_wrap":
        wvec = lane_wrap_weights().to(t.device, t.dtype)
        return lambda: t.reshape(-1, 192) @ wvec
    taps = t.new_zeros(1, 1, 2 * (g + 2) + 3)
    for dy in range(3):
        taps[..., dy * (g + 2):dy * (g + 2) + 3] = 1
    lane0 = t[:, 0].reshape(1, 1, -1)
    return lambda: F.conv1d(lane0, taps)[..., :(r + 2) * g]


def inputs(body: str, device, seed: int = 0, r: int = R, g: int = G):
    """Seeded normal bf16 input of ``body``'s shape (R = G = 80 unless
    given)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shapes(body, r, g)[0], generator=gen,
                       device=device).to(torch.bfloat16)


def main(device: str = "cuda") -> list[dict]:
    """Each body on seeded input against its plain version, with its times
    on a CUDA device beside the library call's and, taken in turns with
    them, the launch floor's.  Prints one line per body; returns the
    records."""
    from mmidet_tpu_torch.tools.timing import (PEAK_F32_FLOPS, launch_floor,
                                               timed)
    recs = []
    for body in BODIES:
        t = inputs(body, device)
        got, want = halo_sum(body, t), halo_sum_reference(body, t)
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        rec = {"body": body, "max_abs_err": err, "max_abs_ref": top,
               "tol": TOL * max(1.0, top), "ok": err <= TOL * max(1.0, top)}
        if not rec["ok"]:
            raise AssertionError(f"halo-sum kernel disagrees with its plain "
                                 f"version on {body}: {rec}")
        library = library_call(body, t)
        rec["library_max_abs_err"] = float(
            (library().float().reshape(-1) - want[..., 0].reshape(-1))
            .abs().max())
        if device != "cpu":
            rec.update(timed(lambda: halo_sum(body, t, out=got),
                             lambda: halo_sum_reference(body, t), library,
                             *work(body), PEAK_F32_FLOPS,
                             floor=launch_floor(t)))
        print(json.dumps({"probe": "cem_r3", **rec}), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
