"""Profiling and model-cost reporting.

Counterpart of ``mmidet_tpu/utils/profiler.py``; reference
``time_synchronized`` (utils/torch_utils.py:89), the per-layer
``profile=True`` path (yolo_test.py:198-208, thop FLOPs), the
``torch_utils.profile`` micro-bench and ``model_info``:

  * ``time_synchronized``: the wall clock after the card's queued work;
  * ``bench_fn``: the median seconds of a call, synchronised;
  * ``trace``: ``torch.profiler`` over a block, its Chrome trace written
    to ``<log_dir>/trace.json``;
  * ``model_cost``: ``gflops`` (``torch.utils.flop_counter``: products,
    convolutions and attention; XLA's ``cost_analysis``, which the JAX
    package reads, counts elementwise operations too, so its count is the
    larger), ``bytes_accessed`` (each operation's tensor inputs and outputs,
    views aside) and ``params_m`` (parameters and BN running statistics,
    the leaves of the JAX package's ``variables``).  The kernels' custom
    ops (K1, K3, K4: ``torch.ops.mmidet.*``) have flop formulas here that
    count the products of their plain versions, so that a model counts the
    same on its kernel route and on its plain one.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# BN running statistics and the s8 deploy's scales: the JAX package's
# batch_stats and quant leaves
_STATE_BUFFERS = ("running_mean", "running_var", "out_scale")


def time_synchronized() -> float:
    """``time.perf_counter()`` after the card's queued work has run (ref
    time_synchronized: cuda.synchronize + time); no sync where CUDA was
    never used."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def bench_fn(fn, *args, iters: int = 10) -> float:
    """Median seconds a call of ``fn(*args)``, synchronised (one call
    first, untimed)."""
    fn(*args)
    times = []
    for _ in range(iters):
        t0 = time_synchronized()
        fn(*args)
        times.append(time_synchronized() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the card's kernels where CUDA is
    in use); ``<log_dir>/trace.json`` gets its Chrome trace.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _stack_flops(b: int, n: int, d: int, stack) -> int:
    """The token transformer's products on (b, n, d) tokens: the four
    weight products (``STACK_KEYS`` 2, 4, 8, 10: wqkv, wo, w1, w2, each
    (L, ...)) and q k^T and p v, 2 n^2 d a layer."""
    layers = stack[4][0]
    weights = sum(math.prod(stack[i]) for i in (2, 4, 8, 10))
    return 2 * b * n * weights + 4 * b * n * n * d * layers


def _k1_flops(x, stack, num_heads, out_shape=None):
    b, n, d = x
    return _stack_flops(b, n, d, stack)


def _k3_flops(x, w2, b2, factor, bias_s, w3, b3, pack=None, out_shape=None):
    # conv 3 -> C (HWIO w2), the edge bank 1 -> C (3x3), conv C -> 3
    pixels = math.prod(x[:3])
    return 2 * pixels * (math.prod(w2) + 9 * bias_s[0] + math.prod(w3))


def _k4_flops(rgb, ir, stack, pos_emb, lnf_scale, lnf_bias, num_heads,
              g1=None, g2=None, out_shape=None):
    # pooling, upsampling and the merges are elementwise; the gate's two
    # products and the stack on the 128 tokens
    from mmidet_tpu_torch.nn.transformer_cuda import TOKENS
    b, c = rgb[0], rgb[3]
    gate = 2 * b * TOKENS * (math.prod(g1) + math.prod(g2)) if g1 else 0
    return gate + _stack_flops(b, TOKENS, c, stack)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda, transformer_cuda
    del cem_cuda, fusion_cuda, transformer_cuda  # the ops are registered
    for op, fn in ((torch.ops.mmidet.fused_token_transformer, _k1_flops),
                   (torch.ops.mmidet.fused_cem, _k3_flops),
                   (torch.ops.mmidet.fused_gpt_merge, _k4_flops)):
        if op not in flop_registry:
            register_flop_formula(op)(fn)


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every operation's tensor inputs and outputs
    (views, which move nothing, aside)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            leaves = tree_flatten((args, kwargs or {}, out))[0]
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def model_cost(model: torch.nn.Module, *example_args, **kwargs) -> dict:
    """FLOPs, bytes and parameters of one ``model(*example_args,
    **kwargs)`` call under ``torch.no_grad`` (thop's role, ref
    torch_utils.model_info)."""
    from torch.utils.flop_counter import FlopCounterMode
    _register_flop_formulas()
    flops = FlopCounterMode(display=False)
    moved = _BytesMode()
    with torch.no_grad(), flops, moved:
        model(*example_args, **kwargs)
    n_params = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for name, b in model.named_buffers()
        if name.rsplit(".", 1)[-1] in _STATE_BUFFERS)
    return {"gflops": flops.get_total_flops() / 1e9,
            "bytes_accessed": float(moved.bytes),
            "params_m": n_params / 1e6}
