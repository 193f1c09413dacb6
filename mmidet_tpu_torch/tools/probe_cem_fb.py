"""P3, the CEM's lane-widened products: a hand-written CUDA kernel, its
plain PyTorch version and the probe's entry point.

Counterpart of ``tools/_probe_cem_fb.py``.  That probe asked whether the
TPU's compiler accepts the lane slices and concatenations that widen a row
before a product; the kernel (``csrc/cem_probes.cu``,
``lane_matmul_kernel``, on the tensor cores) computes what each of its
bodies computes, bf16 operands with f32 sums:

    body         probe           row p of a (M, L)                   w
    slice192     _k_slice192     [a[168:], a, a[:24], 0^16]  (256)   (256, 128)
    slice8       _k_slice8       [a[7:8], a, a[0:1], 0^118]  (128)   (128, 128)
    ones_matmul  _k_ones_matmul  a (192)                             (192, 128)

    out (M, 128) f32 = p @ w

    python -m mmidet_tpu_torch.tools.probe_cem_fb

prints, per body, its largest error against the plain version and its
times on the card (M = 96, the probe's shapes), beside one PyTorch call of
the same product (``library_call``) and an empty launch (the floor).
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
    if a.dim() != 2 or a.shape[1] != lanes or w.shape != (k, 128):
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


def widen_index(body: str) -> torch.Tensor:
    """Per column of the widened row, the lane of a that it reads, or -1
    where it is zero: ``widen`` as an index map, which the kernel applies
    while it stages a's rows (``widen_src`` in ``csrc/cem_probes.cu``)."""
    lanes, k = WIDTH[body]
    idx = torch.full((k,), -1, dtype=torch.long)
    if body == "slice192":
        idx[:240] = torch.cat([torch.arange(168, 192), torch.arange(192),
                               torch.arange(24)])
    elif body == "slice8":
        idx[:10] = torch.tensor([7, *range(8), 0])
    else:
        idx[:] = torch.arange(lanes)
    return idx


def work(body: str, m: int = M) -> tuple[int, int]:
    """(operations, bytes) that ``body``'s function needs at ``m`` rows, for
    its bound: a product over the rows of w that the widened row holds (a
    lane of a reads each: 240, 10 and 192 of 256, 128 and 192), a read
    once, those rows of w read once, the f32 output written once."""
    held = int((widen_index(body) >= 0).sum())
    return (2 * m * held * 128,
            m * WIDTH[body][0] * 2 + held * 128 * 2 + m * 128 * 4)


def lane_matmul_reference(body: str, a, w):
    """Plain PyTorch version: the widened rows times w in f32."""
    _check(body, a, w)
    return widen(body, a.float()) @ w.float()


def lane_matmul(body: str, a, w, out=None):
    """``body``'s (M, 128) f32 output, written into ``out`` when given (a
    contiguous f32 tensor of that shape on a's device).  On a CUDA tensor
    this launches the kernel (one launch); on a CPU tensor it runs the
    plain version."""
    if a.device.type == "cpu":
        got = lane_matmul_reference(body, a, w)
        if out is None:
            return got
        kernels.check_out(out, got.shape, torch.float32, a.device)
        return out.copy_(got)
    if a.device.type != "cuda":
        raise ValueError(f"no lane-matmul kernel for {a.device}")
    _check(body, a, w)
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"lane-matmul kernel takes bf16; got {a.dtype}, "
                         f"{w.dtype}")
    a, w = kernels.aligned(a), kernels.aligned(w)
    if out is None:
        out = torch.empty(len(a), 128, dtype=torch.float32, device=a.device)
    else:
        kernels.check_out(out, (len(a), 128), torch.float32, a.device)
    kernels.check("lane_matmul", kernels.load("lane_matmul")(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), BODIES.index(body),
        len(a), kernels.stream_ptr(a)))
    lane_matmul.launches += 1
    return out


lane_matmul.launches = 0


def fold(body: str, w):
    """w folded over the widening, in f32: row l sums the rows of w that
    read lane l of a, so that ``widen(body, a) @ w == a @ fold(body, w)``
    (slice192: w[24 + l] + [l >= 168] w[l - 168] + [l < 24] w[216 + l])."""
    idx = widen_index(body).to(w.device)
    held = idx >= 0
    return torch.zeros(WIDTH[body][0], 128, device=w.device).index_add_(
        0, idx[held], w.float()[held])


def library_call(body: str, a, w):
    """One PyTorch call of ``body``'s product, as a function of no
    arguments: a in f32 times ``fold(body, w)`` (cuBLAS's f32 product; the
    f32 copy of a and the fold are made here, outside the call)."""
    a32, wf = a.float(), fold(body, w)
    return lambda: a32 @ wf


def inputs(body: str, device, seed: int = 0, m: int = M):
    """Seeded operands as the probe makes them: normal bf16 a (m rows) and
    w; for ``ones_matmul`` the selector that sums each 24 lanes of a
    192-lane row into one of 8 columns (the other 120 zero)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes, k = WIDTH[body]
    a = torch.randn(m, lanes, generator=gen, device=device).to(torch.bfloat16)
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
    on a CUDA device beside the library call's and, taken in turns with
    them, the launch floor's.  Prints one line per body; returns the
    records."""
    from mmidet_tpu_torch.tools.timing import (PEAK_BF16_FLOPS, launch_floor,
                                               timed)
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
        library = library_call(body, a, w)
        rec["library_max_abs_err"] = float((library() - want).abs().max())
        if device != "cpu":
            rec.update(timed(
                lambda: lane_matmul(body, a, w, out=got),
                lambda: lane_matmul_reference(body, a, w), library,
                *work(body, len(a)), PEAK_BF16_FLOPS,
                floor=launch_floor(a)))
        print(json.dumps({"probe": "cem_fb", **rec}), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
