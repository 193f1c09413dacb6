#!/usr/bin/env python3
"""Where the port's main paths spend their time on one NVIDIA card.

    python3 chip_profile.py [p1 | k2 | train | export]

Builds the same seeded deploy models as ``chip_smoke.py`` (BN folded, bf16,
batch 16 at 640x640) and prints JSON lines:
  * ``layer_gemm_tiles``: the layer GEMM that K1 and K4 share, each of a
    layer's four products on each tile the kernel offers, at the main
    paths' shapes (TFLOP/s of device time, beside the tile the layers pick
    and ``F.linear``);
  * ``k3_phases``: K3's bf16 kernel at the flagship's shape with all of its
    phases, each phase alone (input tile, conv2, bank, conv3, store) and
    none, from ``csrc/cem.cu`` built with ``-DCEM_SKIP_PHASES=<mask>``;
  * ``p1_phases``, only when ``p1`` is the only argument, and then
    alone: P1 at the probe's shapes as built and with parts of its
    consumers' work left out (``-DP1_SKIP=<mask>``);
  * ``k2_phases``, only when ``k2`` is the only argument, and then alone:
    K2's large form at B = 16, K = 30000 on four pools, as built and with
    parts of its work left out (``-DNMS_SKIP=<mask>``);
  * ``train_breakdown``, only when ``train`` is the only argument, and
    then alone: the flagship's training at 640, batch 8, bf16 autocast,
    aux losses as the reference, under ``torch.profiler``, in two windows:
    one micro-step as the trainer runs it (augmentation, forward, loss,
    backward) and one optimizer step with the EMA update; each window's
    host wall time with and without the profiler, device busy time and
    idle share (busy time over the unprofiled wall time), device time by the
    PyTorch operator that launched each kernel, and the top kernels;
  * ``export_breakdown``, only when ``export`` is the only argument, and
    then alone: the flagship's deploy form (K3 + K4, batch 16 at 640,
    bf16) as the eager module and as ``deploy.export.export_program``'s
    graph loaded back (``load_program``), one forward of each under
    ``torch.profiler`` as ``train_breakdown`` reads it, and the graph's
    nodes by target (``export_graph``);
  * ``memory_format``: yolov5s_gpt4's forward time in NCHW and in
    channels_last memory format, timed in turns (nchw, cl, cl, nchw) with
    CUDA events;
  * ``breakdown``, once per model and kernel route: one forward + NMS under
    ``torch.profiler``: device time by kernel group (the hand-written
    kernels, convolutions, PyTorch's pooling and resampling, the rest),
    the host wall time of the window and the device's idle share of it;
    the layer GEMM of K1 and K4 by product (its epilogue) and by tile; the
    rest also by the PyTorch operator that launched it.  yolov5s_gpt4
    runs K1 and K2; yolov5l_fuse3_fourier runs K3, K4 and K2, and once more
    with K1, the cuDNN CEM and the unfused pooling and upsampling.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the layer kernels of csrc/token_transformer.cuh run inside K1 or inside K4,
# whichever the route launches (layernorm_kernel<chunks>,
# layernorm_kernel_wide, gemm_kernel<columns, warpgroups, stages,
# epilogue>, attention_kernel<head width>)
_LAYERS = ("layernorm_kernel", "gemm_kernel", "attention_kernel")
# gemm_kernel's epilogue argument names the layer's product
_GEMM = re.compile(r"gemm_kernel<(\d+), *(\d+), *(\d+), *(\d+)>")
_PRODUCT = {"0": "qkv (bias)", "1": "w1 (bias + GELU)",
            "2": "wo and w2 (bias + residual)"}
# PyTorch's own pooling and resampling kernels carry "nhwc" in their names
# as cuDNN's convolutions do, so they are matched first
_POOL = ("pool_resample", ("adaptive_average_pool", "max_pool", "upsample_"))
_CONV = ("convolution", ("conv", "xmma", "implicit", "wgrad", "dgrad",
                         "cudnn", "sm90_", "nhwc", "nchw"))
GROUPS_K1 = (("k1_token_transformer", _LAYERS),
             ("k2_nms_greedy", ("nms_kernel",)), _POOL, _CONV)
GROUPS_K4 = (("k3_fused_cem", ("cem_kernel",)),
             ("k4_pool_gate", ("::pool_kernel", "gate_pos_kernel")),
             ("k4_merge", ("merge_kernel",)),
             ("k4_layers", _LAYERS),
             ("k2_nms_greedy", ("nms_kernel",)), _POOL, _CONV)


# the tiles of csrc/token_transformer.cuh's kTiles, in its order
TILES = ("128x256, 4 stages", "128x128, 4 stages",
         "128x128, 3 stages, 2 blocks per SM", "128x64, 4 stages",
         "64x64, 4 stages")


def gemm_tiles(torch, card: str) -> None:
    """The layer GEMM's four products on every tile at the main paths'
    shapes (B = 16, so M = 2048, at d = 64 .. 1024; and batch 1 at
    d = 1024): TFLOP/s of device time per tile, on the tile the layers
    pick, and for F.linear (no epilogue): the data behind pick_tile."""
    import torch.nn.functional as F

    from chip_smoke import device_ms
    from mmidet_tpu_torch import kernels
    fn = kernels.load("layer_gemm_tile")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(9)
    shapes = [(2048, d) for d in (64, 128, 256, 512, 1024)] + [(128, 1024)]
    for m, d in shapes:
        for prod, n, k, epi in (("qkv", 3 * d, d, 0), ("wo", d, d, 2),
                                ("w1", 4 * d, d, 1), ("w2", d, 4 * d, 2)):
            bf16 = torch.bfloat16
            a = torch.randn(m, k, generator=gen, device=dev).to(bf16)
            w = (torch.randn(n, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(bf16)
            bias = 0.2 * torch.randn(n, generator=gen, device=dev)
            c = torch.randn(m, n, generator=gen, device=dev).to(bf16)
            args = (a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    c.data_ptr(), c.data_ptr(), m, n, k, epi)
            flops = 2 * m * n * k
            rec = {}
            for i, name in [(-1, "picked")] + list(enumerate(TILES)):
                def run(i=i):
                    kernels.check("layer_gemm_tile", fn(*args, i, stream))
                rec[name] = flops / device_ms(run, reps=10) / 1e9
            b16 = bias.to(bf16)
            rec["F.linear"] = flops / device_ms(
                lambda: F.linear(a, w, b16), reps=10) / 1e9
            print(json.dumps({"phase": "layer_gemm_tiles", "card": card,
                              "m": m, "d": d, "product": prod, "n": n,
                              "k": k, "tflops_by_tile": rec}), flush=True)


# K3's bf16 kernel phase by phase: csrc/cem.cu built with -DCEM_SKIP_PHASES,
# the mask of phases its kernel leaves out (bit i: phase i of this list)
_K3_PHASES = ("load", "conv2", "bank", "conv3", "store")


def k3_phases(torch, card: str) -> None:
    """Device time of K3 at (16, 640, 640, 3) bf16 with all phases, each
    phase alone, and none (the launch, weights and barriers)."""
    import ctypes
    import subprocess

    from chip_smoke import device_ms
    from mmidet_tpu_torch import kernels
    from mmidet_tpu_torch.nn import cem_cuda
    every = (1 << len(_K3_PHASES)) - 1
    masks = {"all": 0, "none": every}
    masks.update({f"{n} alone": every & ~(1 << i)
                  for i, n in enumerate(_K3_PHASES)})
    kernels.BUILD.mkdir(exist_ok=True)
    libs = {m: kernels.BUILD / f"libcem_skip{m}.so" for m in masks.values()}
    builds = [subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DCEM_SKIP_PHASES={m}",
         "-o", str(lib), str(kernels.CSRC / "cem.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for m, lib in libs.items()]
    for b in builds:
        err = b.communicate()[1]
        if b.returncode:
            raise RuntimeError(err.decode())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    params = [0.3 * torch.randn(s, generator=gen, device=dev) for s in (
        (3, 3, 3, 24), (24,), (24,), (24,), (3, 3, 24, 3), (3,))]
    x = torch.rand(16, 640, 640, 3, generator=gen, device=dev).to(
        torch.bfloat16)
    pack = cem_cuda.pack_cem_weights(*params, torch.bfloat16)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = {}
    for name, m in masks.items():
        fn = ctypes.CDLL(str(libs[m])).cem_forward
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]

        def run():
            kernels.check("cem", fn(x.data_ptr(), pack.data_ptr(),
                                    out.data_ptr(), 16, 640, 640, 1, stream))
        ms[name] = device_ms(run, reps=10)
    print(json.dumps({"phase": "k3_phases", "card": card,
                      "shape": [16, 640, 640, 3], "device_ms": ms}),
          flush=True)


# P1 (csrc/conv_chain.cu) built with -DP1_SKIP=<mask>, the work its kernel
# leaves out (bit i: item i of this list)
_P1_PARTS = ("products", "A loads", "SiLU", "stores")
P1_VARIANTS = {"all": [],
               **{f"no {n}": [f"-DP1_SKIP={1 << i}"]
                  for i, n in enumerate(_P1_PARTS)},
               "no epilogue": ["-DP1_SKIP=12"],
               "no products, no A loads": ["-DP1_SKIP=3"],
               "none": [f"-DP1_SKIP={(1 << len(_P1_PARTS)) - 1}"]}


def p1_phases(torch, card: str) -> None:
    """P1's device time at the probe's shapes in each build of
    ``P1_VARIANTS``: the kernel as built and with parts of its work left
    out; the error of the full build against the plain version.  Built
    in parallel; timed in turns (every variant, then again in reverse
    order)."""
    variants = P1_VARIANTS
    import ctypes
    import subprocess

    from chip_smoke import device_ms
    from mmidet_tpu_torch import kernels
    from mmidet_tpu_torch.tools import probe_igemm
    kernels.BUILD.mkdir(exist_ok=True)
    libs = {n: kernels.BUILD / f"libconv_chain_v{i}.so"
            for i, n in enumerate(variants)}
    builds = {n: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o", str(libs[n]),
         str(kernels.CSRC / "conv_chain.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for n, flags in variants.items()}
    ptxas = {}
    for n, b in builds.items():
        log = b.communicate()[0].decode()
        if b.returncode:
            raise RuntimeError(log)
        ptxas[n] = [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for n in variants:
        fn = ctypes.CDLL(str(libs[n])).conv_chain_forward
        fn.argtypes = kernels.SIGNATURES["conv_chain"][2]
        fns[n] = fn
    for b, hw, c in ((128, 160, 64), (128, 160, 128), (16, 160, 64)):
        x, w1, w2 = probe_igemm.inputs(b, hw, hw, c, dev)
        p1, p2 = (probe_igemm.prepare_weights(w) for w in (w1, w2))
        out = torch.empty_like(x)
        flops, _ = probe_igemm.chain_work(b, hw, hw, c)
        ms = {n: [] for n in variants}
        for n in [*variants, *reversed(variants)]:
            def run(fn=fns[n]):
                kernels.check("conv_chain", fn(
                    x.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                    out.data_ptr(), b, hw, hw, c, stream))
            ms[n].append(device_ms(run, reps=10))
        out.zero_()
        kernels.check("conv_chain", fns["all"](
            x.data_ptr(), p1.data_ptr(), p2.data_ptr(), out.data_ptr(), b,
            hw, hw, c, stream))
        err = float((out.float() - probe_igemm.conv_chain_reference(
            x, w1, w2).float()).abs().max())
        print(json.dumps({"phase": "p1_phases", "card": card,
                          "shape": [b, hw, hw, c], "device_ms": ms,
                          "max_abs_err": err,
                          "tflops": {n: flops / min(v) / 1e9
                                     for n, v in ms.items()},
                          "ptxas": ptxas}), flush=True)
        del x, out
        torch.cuda.empty_cache()


# K2's large-pool form part by part: csrc/nms_greedy.cu built with
# -DNMS_SKIP=<mask>, the parts its kernel leaves out (bit i: item i)
_K2_PARTS = ("run sort", "rank merge", "workspace write", "scan",
             "in-order check", "top sort")
K2_VARIANTS = {"all": 0, **{f"no {n}": 1 << i for i, n in enumerate(_K2_PARTS)},
               "none": (1 << len(_K2_PARTS)) - 1}
K2_POOLS = ("unsorted", "few_survive", "topk_sorted", "few_survive_sorted")


def k2_phases(torch, card: str) -> None:
    """K2's large form at B = 16, K = 30000 (the evaluator's
    ``pre_nms_topk``) on four pools of ``chip_smoke.py:k2_pools``: the
    kernel's own count of its scan per image, caller's ms, device ms and
    bound through the wrapper; then device ms of each build of
    ``K2_VARIANTS`` (the kernel as built and with parts left out), timed
    in turns (every variant, then again in reverse order)."""
    import ctypes
    import subprocess

    from chip_smoke import (device_ms, k2_bound, k2_pools, nms_pool,
                            time_ms)
    from mmidet_tpu_torch import kernels
    from mmidet_tpu_torch.ops import nms_cuda
    kernels.BUILD.mkdir(exist_ok=True)
    libs = {n: kernels.BUILD / f"libnms_greedy_skip{m}.so"
            for n, m in K2_VARIANTS.items()}
    builds = {n: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DNMS_SKIP={m}", "-o",
         str(libs[n]), str(kernels.CSRC / "nms_greedy.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for n, m in K2_VARIANTS.items()}
    for b in builds.values():
        log = b.communicate()[0].decode()
        if b.returncode:
            raise RuntimeError(log)
    fns = {}
    for n in K2_VARIANTS:
        fn = ctypes.CDLL(str(libs[n])).nms_greedy_forward
        fn.argtypes = kernels.SIGNATURES["nms_greedy"][2]
        fns[n] = fn
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    B, K, max_det, thr = 16, 30000, 300, 0.45
    boxes, scores = nms_pool(torch, B, K, torch.Generator().manual_seed(2))
    pools = k2_pools(torch, boxes.to(dev), scores.to(dev))
    idx = torch.empty(B, max_det, dtype=torch.int32, device=dev)
    valid = torch.empty(B, max_det, dtype=torch.bool, device=dev)
    work = torch.empty(nms_cuda.workspace_bytes(B, K, max_det),
                       dtype=torch.uint8, device=dev)
    for name in K2_POOLS:
        b, s = pools[name]
        stats = torch.zeros(B, nms_cuda.STATS_COLUMNS, dtype=torch.int32,
                            device=dev)
        nms_cuda.nms_greedy(b, s, thr, max_det, stats=stats)
        torch.cuda.synchronize()
        bound_ms, bound_by = k2_bound(stats, B, K, max_det)
        rec = {"pool": name, "stats_per_image": stats.tolist(),
               "ms": time_ms(lambda: nms_cuda.nms_greedy(b, s, thr,
                                                          max_det)),
               "device_ms_wrapper": device_ms(lambda: nms_cuda.nms_greedy(
                   b, s, thr, max_det)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        ms = {n: [] for n in K2_VARIANTS}
        for n in [*K2_VARIANTS, *reversed(K2_VARIANTS)]:
            def run(fn=fns[n]):
                kernels.check("nms_greedy", fn(
                    b.data_ptr(), s.data_ptr(), idx.data_ptr(),
                    valid.data_ptr(), None, work.data_ptr(), B, K, max_det,
                    thr, stream))
            ms[n].append(device_ms(run, reps=10))
        print(json.dumps({"phase": "k2_phases", "card": card,
                          "batch": B, "pool_size": K, **rec,
                          "device_ms": ms}), flush=True)


def group_of(name: str, groups) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def breakdown(torch, model, rgb, ir, groups, label: dict) -> None:
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        return non_max_suppression(model(rgb, ir)["pred"].float(),
                                   conf_thres=0.001, iou_thres=0.45)

    with torch.inference_mode():
        step()
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # cuDNN runs 1x1 convolutions as library matrix kernels (``nvjet_*``)
    # whose names say nothing of convolution: what the convolution operator
    # launched counts as convolution whatever its name
    cpu_ops = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    conv_kernels = {k.name for e in cpu_ops
                    if e.name == "aten::cudnn_convolution" for k in e.kernels}

    def group(name: str) -> str:
        g = group_of(name, groups)
        return "convolution" if g == "other" and name in conv_kernels else g

    # Device time per kernel, each instant charged to one kernel.  The layer
    # kernels are programmatic dependent launches: each is scheduled while
    # the kernel before it drains and waits for it, so their traced
    # intervals overlap that kernel's.  The overlap is charged to the
    # earlier kernel, which does the work then, and the charges sum to the
    # time the card was busy.
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    reach = float("-inf")
    by_group: dict[str, float] = {}
    launches: dict[str, int] = {}
    top: dict[str, list] = {}
    gemm: dict[str, list] = {}  # the layer GEMM by product and by tile
    for evt in kernels:
        own_ms = max(0.0, evt.time_range.end
                     - max(evt.time_range.start, reach)) / 1e3
        reach = max(reach, evt.time_range.end)
        g = group(evt.name)
        by_group[g] = by_group.get(g, 0.0) + own_ms
        launches[g] = launches.get(g, 0) + 1
        keys = [evt.name[:80]]
        m = _GEMM.search(evt.name)
        if m is not None:
            keys += [_PRODUCT[m.group(4)],
                     f"tile {64 * int(m.group(2))}x{m.group(1)}, "
                     f"{m.group(3)} stages"]
        for i, key in enumerate(keys):
            acc = (top if i == 0 else gemm).setdefault(key, [0.0, 0])
            acc[0] += own_ms
            acc[1] += 1
    # the "other" group by the PyTorch operator that launched each kernel
    other_by_op: dict[str, list] = {}
    for evt in cpu_ops:
        for k in evt.kernels:
            if group(k.name) == "other":
                acc = other_by_op.setdefault(evt.name, [0.0, 0])
                acc[0] += k.duration / 1e3
                acc[1] += 1
    busy = sum(by_group.values())
    print(json.dumps({
        "phase": "breakdown", **label, "window": "one forward + NMS",
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": (1 - busy / wall_ms) if busy else "not measured",
        "device_ms_by_group": by_group, "launches_by_group": launches,
        "layer_gemm_ms_and_launches": gemm or "no layer GEMM launched",
        "top_kernels_ms_and_launches": dict(
            sorted(top.items(), key=lambda kv: -kv[1][0])[:14]),
        "other_by_operator_ms_and_launches": dict(
            sorted(other_by_op.items(), key=lambda kv: -kv[1][0])[:14])
        or "not measured",
        "matrix_kernels_of_convolutions_ms": sum(
            k.duration for e in cpu_ops if e.name == "aten::cudnn_convolution"
            for k in e.kernels if "nvjet" in k.name.lower()) / 1e3}),
          flush=True)


def profiled(torch, fn, label: dict, reps: int = 5,
             phase: str = "train_breakdown") -> None:
    """``fn()`` once under ``torch.profiler``: the device's busy time,
    device time by launching operator and by kernel (overlapping intervals
    charged once, to the earlier).  The profiler slows the host, so the
    window's wall time is also the median of ``reps`` calls without it,
    and the idle share is the busy time over that (``idle_share``; the
    profiled window's own is ``idle_share_profiled``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    plain_ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    plain = statistics.median(plain_ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    reach, busy, by_kernel = float("-inf"), 0.0, {}
    for evt in kernels:
        own = max(0.0, evt.time_range.end
                  - max(evt.time_range.start, reach)) / 1e3
        reach = max(reach, evt.time_range.end)
        busy += own
        acc = by_kernel.setdefault(evt.name[:80], [0.0, 0])
        acc[0] += own
        acc[1] += 1
    by_op: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU:
            continue
        for k in evt.kernels:
            acc = by_op.setdefault(evt.name, [0.0, 0])
            acc[0] += k.duration / 1e3
            acc[1] += 1

    def top(d, n):
        return dict(sorted(d.items(), key=lambda kv: -kv[1][0])[:n])
    print(json.dumps({
        "phase": phase, **label, "wall_ms": plain,
        "wall_ms_unprofiled": plain_ms, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy,
        "idle_share": (1 - busy / plain) if busy else "not measured",
        "idle_share_profiled": (1 - busy / wall_ms) if busy
        else "not measured",
        "launches": len(kernels),
        "device_ms_and_launches_by_operator": top(by_op, 24),
        "top_kernels_ms_and_launches": top(by_kernel, 12)}), flush=True)


def train_breakdown(torch, card: str) -> None:
    """The flagship's training on the card: see the module docstring."""
    from mmidet_tpu_torch.data.augment import AugmentHyp, make_batch_augment
    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.models.zoo import get_model_spec
    from mmidet_tpu_torch.train.optimizer import build_optimizer
    from mmidet_tpu_torch.train.schedule import ScheduleConfig
    from mmidet_tpu_torch.train.step import init_state, make_train_step
    from mmidet_tpu_torch.train.trainer import anchors_grid
    dev = torch.device("cuda", 0)
    B, S, T = 8, 640, 120
    torch.manual_seed(0)
    spec = get_model_spec("yolov5l_fuse3_fourier", nc=2)
    model = TwoStreamDetector(spec, aux_mode="reference").to(dev)
    opt, _ = build_optimizer(model, ScheduleConfig(), 0.0005,
                             total_batch_size=B, nbs=64)
    state = init_state(model, opt)
    step = make_train_step(anchors_grid(spec).to(dev), dtype="bfloat16")
    augment = make_batch_augment(S, AugmentHyp(), T)
    gen = torch.Generator(device=dev).manual_seed(1)
    targets = torch.zeros(B, T, 5, device=dev)
    targets[:, :10, 0] = torch.randint(0, 2, (B, 10), generator=gen,
                                       device=dev).float()
    targets[:, :10, 1:] = torch.rand(B, 10, 4, generator=gen,
                                     device=dev) * 0.3 + 0.2
    raw = {"rgb": torch.rand(B, S, S, 3, generator=gen, device=dev),
           "ir": torch.rand(B, S, S, 3, generator=gen, device=dev),
           "targets": targets,
           "mask": torch.arange(T, device=dev).expand(B, T) < 10}

    def micro_step():
        state.micro_step = 1  # no optimizer step in this window
        step(state, augment(raw, gen))

    def optimizer_step():
        state.optimizer.step(state.opt_step)
        state.ema.update(state.model)
    for _ in range(3):  # warm-up: cuDNN's choices, the caching allocator
        micro_step()
    optimizer_step()
    label = {"card": card, "model": "yolov5l_fuse3_fourier", "batch": B,
             "img": S, "dtype": "bfloat16 autocast",
             "aux_mode": "reference"}
    micro_step()  # gradients to step on
    profiled(torch, micro_step, {**label, "window": "one micro-step "
                                 "(augment, forward, loss, backward)"})
    profiled(torch, optimizer_step, {**label, "window": "one optimizer "
                                     "step (SGD, 3 groups) + EMA update"})


def export_breakdown(torch, card: str) -> None:
    """The flagship's deploy form (BN folded, bf16, K3 + K4, batch 16 at
    640) as the eager module and as ``export_program``'s graph loaded
    back, each forward under ``torch.profiler`` (``profiled``), and the
    exported graph's nodes by target."""
    from chip_smoke import build_model
    from mmidet_tpu_torch.deploy.export import export_program, load_program
    from mmidet_tpu_torch.models.zoo import get_model_spec
    dev = torch.device("cuda", 0)
    B, S = 16, 640
    model = build_model(torch, get_model_spec("yolov5l_fuse3_fourier"),
                        kernel_cem=True, kernel_merge=True).to(
        dev, torch.bfloat16)
    prog = load_program(export_program(model, S, B))
    nodes: dict[str, int] = {}
    for n in prog.graph.nodes:
        if n.op == "call_function":
            nodes[str(n.target)] = nodes.get(str(n.target), 0) + 1
    gen = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(B, S, S, 3, generator=gen, device=dev)
    ir = torch.rand(B, S, S, 3, generator=gen, device=dev)
    label = {"card": card, "model": "yolov5l_fuse3_fourier", "batch": B,
             "img": S, "dtype": "bfloat16", "route": "K3 + K4"}
    print(json.dumps({"phase": "export_graph", **label,
                      "call_function_nodes": sum(nodes.values()),
                      "nodes_by_target": dict(sorted(
                          nodes.items(), key=lambda kv: -kv[1])[:24])}),
          flush=True)
    with torch.inference_mode():
        for fn in (lambda: model(rgb, ir)["pred"], lambda: prog(rgb, ir)):
            fn()
            fn()
        profiled(torch, lambda: model(rgb, ir)["pred"],
                 {**label, "window": "one eager forward"},
                 phase="export_breakdown")
        profiled(torch, lambda: prog(rgb, ir),
                 {**label, "window": "one forward of the loaded .pt2"},
                 phase="export_breakdown")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import build_model, card_line, set_kernel_flags, time_ms
    from mmidet_tpu_torch.models.zoo import get_model_spec

    dev = torch.device("cuda", 0)
    card = card_line()
    B, S = 16, 640
    gen = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(B, S, S, 3, generator=gen, device=dev)
    ir = torch.rand(B, S, S, 3, generator=gen, device=dev)
    label = {"card": card, "batch": B, "img": S}

    if sys.argv[1:] == ["p1"]:
        p1_phases(torch, card)
        return 0
    if sys.argv[1:] == ["k2"]:
        k2_phases(torch, card)
        return 0
    if sys.argv[1:] == ["train"]:
        train_breakdown(torch, card)
        return 0
    if sys.argv[1:] == ["export"]:
        export_breakdown(torch, card)
        return 0
    gemm_tiles(torch, card)
    k3_phases(torch, card)
    model = build_model(torch, get_model_spec("yolov5s_gpt4")).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        times = {"nchw": [], "channels_last": []}
        for fmt in ("nchw", "channels_last", "channels_last", "nchw"):
            model.to(memory_format=torch.channels_last
                     if fmt == "channels_last" else torch.contiguous_format)
            times[fmt].append(time_ms(lambda: model(rgb, ir), reps=10,
                                      warmup=2))
        print(json.dumps({"phase": "memory_format", **label,
                          "model": "yolov5s_gpt4",
                          "forward_ms_per_batch": times}), flush=True)
        model.to(memory_format=torch.contiguous_format)
    breakdown(torch, model, rgb, ir, GROUPS_K1,
              {**label, "model": "yolov5s_gpt4", "route": "K1 + K2"})
    del model
    torch.cuda.empty_cache()

    model = build_model(torch, get_model_spec("yolov5l_fuse3_fourier"),
                        kernel_cem=True, kernel_merge=True).to(
        dev, torch.bfloat16)
    breakdown(torch, model, rgb, ir, GROUPS_K4,
              {**label, "model": "yolov5l_fuse3_fourier",
               "route": "K3 + K4 + K2"})
    set_kernel_flags(model, kernel_fusion=True, kernel_cem=False,
                     kernel_merge=False)
    breakdown(torch, model, rgb, ir, GROUPS_K1,
              {**label, "model": "yolov5l_fuse3_fourier",
               "route": "K1 + K2, cuDNN CEM, unfused pooling and upsampling"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
