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
times, on the card (R = G = 80, the probe's shapes).
"""

from __future__ import annotations

import json

import torch

from mmidet_tpu_torch import kernels

R = G = 80
BODIES = ("halo_concat", "halo_roll", "lane_wrap", "flat_gather")
# the f32 sums differ only in order, which can flip the one bf16 rounding:
# one bf16 step, 2^-8 of max(1, |value|)
TOL = 2.0 ** -8


def shapes(body: str, r: int = R, g: int = G):
    """(input shape, output shape) of ``body``."""
    return {"halo_concat": ((r + 4, g + 2, 8), (r + 2, g, 8)),
            "halo_roll": ((r + 4, g, 8), (r + 2, g, 8)),
            "lane_wrap": ((r + 2, g, 192), (r + 2, g, 8)),
            "flat_gather": (((r + 4) * (g + 2), 8), ((r + 2) * g, 8))}[body]


def _check(body: str, t, r: int, g: int) -> None:
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}; got {body!r}")
    if tuple(t.shape) != shapes(body, r, g)[0]:
        raise ValueError(f"{body} takes {shapes(body, r, g)[0]}; got "
                         f"{tuple(t.shape)}")


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


def halo_sum(body: str, t, r: int = R, g: int = G):
    """``body``'s output.  On a CUDA tensor this launches the kernel (one
    launch); on a CPU tensor it runs the plain version."""
    if t.device.type == "cpu":
        return halo_sum_reference(body, t, r, g)
    if t.device.type != "cuda":
        raise ValueError(f"no halo-sum kernel for {t.device}")
    _check(body, t, r, g)
    if t.dtype != torch.bfloat16:
        raise ValueError(f"halo-sum kernel takes bf16; got {t.dtype}")
    t = t.contiguous()
    out = torch.empty(shapes(body, r, g)[1], dtype=torch.float32,
                      device=t.device)
    fn = kernels.load("halo_sum")
    kernels.check("halo_sum", fn(t.data_ptr(), out.data_ptr(),
                                 BODIES.index(body), r, g,
                                 kernels.stream_ptr(t)))
    halo_sum.launches += 1
    return out


halo_sum.launches = 0


def inputs(body: str, device, seed: int = 0):
    """Seeded normal bf16 input of ``body``'s shape at R = G = 80."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shapes(body)[0], generator=gen, device=device).to(
        torch.bfloat16)


def main(device: str = "cuda") -> list[dict]:
    """Each body on seeded input against its plain version, with its times
    on a CUDA device.  Prints one line per body; returns the records."""
    from mmidet_tpu_torch.tools.timing import PEAK_F32_FLOPS, timed
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
        if device != "cpu":
            # the gathered values read once (bf16), the output written once
            # (f32); one add per gathered value
            adds = want[..., 0].numel() * {"halo_concat": 10, "halo_roll": 10,
                                           "lane_wrap": 240,
                                           "flat_gather": 9}[body]
            rec.update(timed(lambda: halo_sum(body, t),
                             lambda: halo_sum_reference(body, t), None, adds,
                             t.numel() * 2 + want.numel() * 4,
                             PEAK_F32_FLOPS))
        print(json.dumps({"probe": "cem_r3", **rec}), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
