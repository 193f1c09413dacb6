"""Timing on the card, shared by the probes' entry points and
``chip_smoke.py``: CUDA-event medians, the least time the card could take
for a piece of work (its bound) and the time of an empty launch (the
floor under every kernel's)."""

from __future__ import annotations

import statistics

import torch

from mmidet_tpu_torch import kernels

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
          peak_flops: float, plain_reps: int = 20, floor=None) -> dict:
    """The times of one kernel call beside its plain version's, the
    library call's (``library`` may be None) and its bound.  With
    ``floor`` (``launch_floor``'s function) the kernel's ms and device ms
    are each taken in turns with the floor's (floor, kernel, kernel,
    floor): the record gives the mean of each one's two readings, and the
    floor's two as ``floor_ms_turns`` and ``floor_device_ms_turns``."""
    bound_ms, bound_by = bound(flops, nbytes, peak_flops)
    rec = {}
    for key, measure in (("ms", time_ms), ("device_ms", device_ms)):
        if floor is None:
            rec[key] = measure(kernel)
            continue
        f0, k0, k1, f1 = (measure(fn) for fn in (floor, kernel, kernel,
                                                  floor))
        rec.update({key: (k0 + k1) / 2, f"floor_{key}": (f0 + f1) / 2,
                    f"floor_{key}_turns": [f0, f1]})
    return {**rec, "plain_ms": time_ms(plain, reps=plain_reps, warmup=1),
            "library_ms": None if library is None else time_ms(library),
            "library_device_ms": None if library is None
            else device_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by}


def launch_floor(t: torch.Tensor):
    """One launch of an empty kernel on ``t``'s card, as a function of no
    arguments, made as the probes' wrappers make theirs (``kernels.load``,
    the stream pointer, one ctypes call, ``kernels.check``): timed like a
    kernel, what a launch costs before any work."""
    def run():
        kernels.check("launch_floor",
                      kernels.load("launch_floor")(kernels.stream_ptr(t)))
    return run
