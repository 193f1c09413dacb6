"""Timing on the card, shared by the probes' entry points and
``chip_smoke.py``: CUDA-event medians and the least time the card could
take for a piece of work (its bound)."""

from __future__ import annotations

import statistics

import torch

# A bound takes the card's peak for the operands' type, whichever units the
# kernel itself runs on: bf16 operands with f32 accumulation count at the
# tensor cores' rate, f32 operands at the f32 rate.
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
SPIN_CYCLES = 10_000_000   # about 5 ms at the H100's clock: device_ms


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn()`` over ``reps`` runs (CUDA events), the host's
    time between its launches included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()``: a spin kernel queued ahead of the
    first event keeps the card busy while the host queues ``fn``'s
    launches, so the host's own time between them (Python, argument
    checks, launch calls) is not counted, as it is in ``time_ms``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(ms, "operations" or "bytes"): the larger of ``flops`` at
    ``peak_flops`` and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def timed(kernel, plain, library, flops: float, nbytes: float,
          peak_flops: float, plain_reps: int = 20) -> dict:
    """The times of one kernel call beside its plain version's, the
    library call's (``library`` may be None) and its bound."""
    bound_ms, bound_by = bound(flops, nbytes, peak_flops)
    return {"ms": time_ms(kernel), "device_ms": device_ms(kernel),
            "plain_ms": time_ms(plain, reps=plain_reps, warmup=1),
            "library_ms": None if library is None else time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by}
