#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmidet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from ``mmidet_tpu_torch/csrc`` (nvcc);
     ptxas's register count of every kernel;
  3. the layer GEMM that K1 and K4 share (``layer_gemm``), alone, for the
     four products of a layer at B = 16 (M = 2048), d = 512 and 1024, each
     epilogue against its plain version: device time, TFLOP/s and share of
     the bf16 peak, beside ``F.linear`` plus the same epilogue;
  4. K1, the fused token transformer, against its plain PyTorch version at
     the main paths' shapes (B = 16, 128 tokens, L = 8, d = 64..1024), with
     kernel, plain, library (torch.matmul + SDPA) and bound times;
  5. K2, greedy NMS, against its plain version (B = 16, K = 4096,
     max_det = 300): identical indices on the seeded unsorted pool, a
     tie-heavy one, one sorted as ``torch.topk`` hands it on, one of
     duplicate boxes and one of which few boxes survive; the kernel's own
     count of its chunk rounds per image, held against the sorted pool;
     timed on the seeded pool and on the one of few survivors;
  6. K3, the fused CEM, against its plain version at (16, 640, 640, 3) in
     bf16 and f32 and at an odd shape that crosses tile borders; library
     time: the port's unfused ``ContourEnhance`` (cuDNN; TF32 off for the
     f32 form);
  7. K4, the fused GPT merge, against its plain version at the flagship's
     four levels (gated at C = 128; 256, 512, 1024; B = 16, L = 8); library
     time: adaptive_avg_pool + cuBLAS/SDPA transformer + interpolate + adds;
  8. the first main path: yolov5s_gpt4 at full width and depth, seeded
     random weights, BN folded, bf16, batch 16 at 640x640, forward + NMS
     through K1 and K2 (launch counts asserted), throughput; the same path
     in f32 against the plain versions on the CPU at a small input; then
     ``DetectionService`` answers 3 requests;
  9. the flagship path: yolov5l_fuse3_fourier, the same way, through K3, K4
     and K2 (``kernel_cem``, ``kernel_merge``), and timed in turns against
     the same model with those two flags off and ``kernel_fusion`` on (K1,
     cuDNN CEM, unfused pooling and upsampling);
  10. the ``kernels`` summary line, the card line, and the final
     ``{"ok": true, "device": ...}`` line.
Times: ``ms`` is a CUDA-event median around each call (the host's time
between launches included, as a caller sees it); ``device_ms`` queues the
call behind a spin kernel so that only the card's time counts.
"""

from __future__ import annotations

import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# A bound takes the card's peak for the operands' type, whichever units the
# kernel itself runs on: bf16 operands with f32 accumulation count at the
# tensor cores' rate, f32 operands at the f32 rate.
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
SPIN_CYCLES = 10_000_000   # about 5 ms at the H100's clock: device_ms
# K1: max |kernel - plain| <= 2% of max |plain|.  The two differ only in
# the order of f32 sums, but every layer rounds to bf16 (2^-8 relative) at
# six points, so one flipped rounding compounds through 8 dependent layers.
K1_TOL = 0.02
# K3 in bf16: five rounding points; one flipped rounding of y + e moves z by
# one bf16 step (2^-8 relative): 2% of max |plain|.  In f32 the two differ in
# the order of sums only: 1e-4 of max |plain|.
K3_TOL = {"bfloat16": 0.02, "float32": 1e-4}
# K4: K1's gate; the merge adds one bf16 rounding to K1's compounding ones.
K4_TOL = 0.02
# the layer GEMM alone: sums in another order flip single bf16 roundings
# (2^-8 of a value), nothing compounds: 1e-2 of max |plain|
GEMM_TOL = 1e-2
PATH_TOL = 2e-2                 # f32 model, kernels vs plain versions
LEVELS = ((128, 160, True), (256, 80, False), (512, 40, False),
          (1024, 20, False))    # flagship fusion levels at 640: C, H = W, gate


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch
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
    import torch
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
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phase 3
def phase_layer_gemm(torch, dev, card: str):
    """The four products of one layer at B = 16, d = 512 and 1024, through
    the standalone entry point of the GEMM that K1 and K4 run."""
    import torch.nn.functional as F

    from mmidet_tpu_torch.nn import transformer_cuda as tc
    M, bf16 = 16 * 128, torch.bfloat16
    gen = torch.Generator().manual_seed(8)
    recs = []
    for d in (512, 1024):
        for prod, n, k, epi in (("qkv", 3 * d, d, "bias"),
                                ("wo", d, d, "residual"),
                                ("w1", 4 * d, d, "gelu"),
                                ("w2", d, 4 * d, "residual")):
            a = torch.randn(M, k, generator=gen).to(dev, bf16)
            w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).to(dev, bf16)
            bias = (0.2 * torch.randn(n, generator=gen)).to(dev)
            res = None
            if epi == "residual":
                res = torch.randn(M, n, generator=gen).to(dev, bf16)
            ref = tc.layer_gemm_reference(a, w, bias, epi, res).float()
            out = tc.layer_gemm(a, w, bias, epi,
                                None if res is None else res.clone()).float()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            top = float(ref.abs().max())
            scratch = None if res is None else res.clone()
            bias16 = bias.to(bf16)

            def library(a=a, w=w, bias16=bias16, epi=epi, res=res):
                y = F.linear(a, w, bias16)
                return (F.gelu(y) if epi == "gelu"
                        else res + y if epi == "residual" else y)
            flops = 2 * M * n * k
            nbytes = 2 * (M * k + n * k + M * n * (2 if res is not None
                                                   else 1)) + 4 * n
            bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            ms = device_ms(lambda: tc.layer_gemm(a, w, bias, epi, scratch))
            lib_ms = device_ms(library)
            rec = {"d": d, "product": prod, "m": M, "n": n, "k": k,
                   "epilogue": epi, "max_abs_err": err, "max_abs_ref": top,
                   "tol": GEMM_TOL, "ms": ms,
                   "wall_ms": time_ms(
                       lambda: tc.layer_gemm(a, w, bias, epi, scratch)),
                   "tflops": flops / ms / 1e9,
                   "peak_share": flops / ms * 1e3 / PEAK_BF16_FLOPS,
                   "library_ms": lib_ms,
                   "library_tflops": flops / lib_ms / 1e9,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "card": card, "ok": err <= GEMM_TOL * top}
            emit({"phase": "layer_gemm", **rec})
            if not rec["ok"]:
                raise AssertionError(f"layer GEMM {prod} at d={d} disagrees "
                                     f"with its plain version: {err} at "
                                     f"|ref| {top}")
            recs.append(rec)
            del a, w, res, ref, out, scratch
    return recs


# ------------------------------------------------------------------ phase 4
def random_stack(d: int, L: int, gen, device):
    """Per-layer weights in torch Linear layout; LN and bias vectors
    randomised (normal * 0.2) so that bias handling is exercised."""
    import torch

    def mat(out, inp):
        return (torch.randn(L, out, inp, generator=gen)
                / math.sqrt(inp)).to(device)

    def vec(n, base=0.0):
        return (base + 0.2 * torch.randn(L, n, generator=gen)).to(device)

    return {"ln1_scale": vec(d, 1.0), "ln1_bias": vec(d),
            "wq": mat(d, d), "wk": mat(d, d), "wv": mat(d, d),
            "bq": vec(d), "bk": vec(d), "bv": vec(d),
            "wo": mat(d, d), "bo": vec(d),
            "ln2_scale": vec(d, 1.0), "ln2_bias": vec(d),
            "w1": mat(4 * d, d), "b1": vec(4 * d),
            "w2": mat(d, 4 * d), "b2": vec(d)}


def library_transformer(x, st, heads: int):
    """The same function from PyTorch's own operators (cuBLAS and SDPA),
    all in bf16: a yardstick for the kernel, never called by the port."""
    import torch
    import torch.nn.functional as F
    b, n, d = x.shape
    a = x
    for l in range(st["wqkv"].shape[0]):
        y = F.layer_norm(a, (d,), st["ln1_scale"][l], st["ln1_bias"][l], 1e-5)
        q, k, v = F.linear(y, st["wqkv"][l], st["bqkv"][l]).view(
            b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v)
        a = a + F.linear(ctx.transpose(1, 2).reshape(b, n, d), st["wo"][l],
                         st["bo"][l])
        y = F.layer_norm(a, (d,), st["ln2_scale"][l], st["ln2_bias"][l], 1e-5)
        a = a + F.linear(F.gelu(F.linear(y, st["w1"][l], st["b1"][l])),
                         st["w2"][l], st["b2"][l])
    return a


def k1_work(B: int, L: int, n: int, d: int):
    """Operations and bytes of one token-transformer call."""
    return (L * B * (24 * n * d * d + 4 * n * n * d),
            L * 12 * d * d * 2 + 2 * B * n * d * 2)


def library_stack(torch, st):
    lib = {k: v.to(torch.bfloat16) for k, v in st.items()}
    lib["wqkv"] = torch.cat([lib["wq"], lib["wk"], lib["wv"]], 1)
    lib["bqkv"] = torch.cat([lib["bq"], lib["bk"], lib["bv"]], 1)
    return lib


def phase_k1(torch, dev):
    from mmidet_tpu_torch.nn import transformer_cuda as tc
    B, L, heads, n = 16, 8, 8, tc.TOKENS
    gen = torch.Generator().manual_seed(1)
    shapes = []
    for d in (64, 128, 256, 512, 1024):
        x = torch.randn(B, n, d, generator=gen).to(dev, torch.bfloat16)
        st = random_stack(d, L, gen, dev)
        ref = tc.fused_token_transformer_reference(x, st, heads).float()
        out = tc.fused_token_transformer(x, st, heads).float()
        torch.cuda.synchronize()
        err = (out - ref).abs()
        ok = bool(err.max() <= K1_TOL * ref.abs().max())
        lib_st = library_stack(torch, st)
        lib = library_transformer(x, lib_st, heads).float()
        # the model keeps the kernel's weight buffers between forwards
        # (nn/fusion.py:_stacked): "ms" is timed so, "ms_with_stacking"
        # with the per-call casts and concatenation of a caller that does not
        prep = tc.prepare_stack(st, dev)
        flops, nbytes = k1_work(B, L, n, d)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        rec = {
            "d": d, "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "max_abs_ref": float(ref.abs().max()),
            "library_max_abs_err": float((lib - ref).abs().max()),
            "ms": time_ms(lambda: tc.fused_token_transformer(x, prep, heads)),
            "device_ms": device_ms(
                lambda: tc.fused_token_transformer(x, prep, heads)),
            "ms_with_stacking": time_ms(
                lambda: tc.fused_token_transformer(x, st, heads)),
            "plain_ms": time_ms(
                lambda: tc.fused_token_transformer_reference(x, st, heads)),
            "library_ms": time_ms(
                lambda: library_transformer(x, lib_st, heads)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "ok": ok}
        emit({"phase": "k1_token_transformer", **rec})
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"d={d}: max |err| {rec['max_abs_err']}")
        shapes.append(rec)
    return shapes


# ------------------------------------------------------------------ phase 5
def nms_pool(torch, B: int, K: int, gen, n_cls: int = 6):
    """Seeded pool of class-offset boxes with distinct scores (10% of the
    slots invalid, at -inf)."""
    xy = torch.rand(B, K, 2, generator=gen) * 640
    wh = 4 + torch.rand(B, K, 2, generator=gen) * 160
    cls = torch.randint(0, n_cls, (B, K, 1), generator=gen).float()
    boxes = torch.cat([xy, xy + wh], -1) + cls * 4096.0
    scores = (torch.stack([torch.randperm(K, generator=gen)
                           for _ in range(B)]).float() + 1) / (K + 1)
    scores[torch.rand(B, K, generator=gen) < 0.1] = -torch.inf
    return boxes, scores


def k2_pools(torch, boxes, scores):
    """The pools K2 is held against: the seeded unsorted pool, the same
    with scores on a 1/16 grid (many ties), sorted as ``torch.topk`` hands
    it on in the main path (``ops/nms.py``), every box twice (IoU 1), and
    large boxes near the image's centre, of which few survive, so that the
    scan consumes every valid candidate."""
    _, K = scores.shape
    valid = scores > -torch.inf
    ties = torch.where(valid, torch.floor(scores * 16) / 16, scores)
    top, order = torch.topk(scores, K, 1)
    dup = boxes.clone()
    dup[:, K // 2:] = boxes[:, :K - K // 2]
    offset = torch.floor(boxes[..., :1] / 4096) * 4096  # the class offset
    xy = 280 + (boxes[..., :2] - offset) / 8  # inside 280..360
    big = torch.cat([xy, xy + 300 + (boxes[..., 2:] - boxes[..., :2]) / 4],
                    -1) + offset
    return {"unsorted": (boxes, scores), "tie_heavy": (boxes, ties),
            "topk_sorted": (boxes.gather(1, order[..., None].expand(
                -1, -1, 4)), top),
            "duplicates": (dup, scores), "few_survive": (big, scores)}


def expected_scan(torch, scores, keep_idx, keep_valid, max_det: int,
                  chunk: int = 64):
    """What K2's own count of its scan (``nms_greedy(stats=)``) must read,
    per image, from greedy's result: the scan consumes the sorted pool up
    to the max_det-th kept box, or every valid candidate when fewer are
    kept, in ceil(consumed / chunk) rounds."""
    key = torch.where(scores > -torch.inf, -scores, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(
            order).contiguous())
    kept = keep_valid.sum(1)
    n_valid = (scores > -torch.inf).sum(1)
    last = torch.where(keep_valid, rank.gather(1, keep_idx.long()), -1)
    consumed = torch.where(kept >= max_det, last.amax(1) + 1, n_valid)
    rounds = torch.div(consumed + chunk - 1, chunk, rounding_mode="floor")
    return torch.stack([rounds, consumed, kept, n_valid], 1).to(torch.int32)


def k2_bound(stats, B: int, K: int, max_det: int):
    """K2's bound from what this pool's greedy selection needs: each box
    read and each index written once; the IoUs that decide it (every kept
    box against the kept boxes before it, every other consumed candidate
    against one kept box, 14 f32 operations each) and a comparison sort of
    the valid candidates (n log2 n comparisons)."""
    ops = 0.0
    for rounds, consumed, kept, n_valid in stats.tolist():
        ops += 14 * (kept * (kept - 1) / 2 + consumed - kept)
        ops += n_valid * math.log2(max(n_valid, 2))
    return bound(ops, B * K * (16 + 4) + B * max_det * (4 + 1),
                 PEAK_F32_FLOPS)


def phase_k2(torch, dev):
    from mmidet_tpu_torch.ops import nms_cuda
    B, K, max_det, thr = 16, 4096, 300, 0.45
    boxes, scores = nms_pool(torch, B, K, torch.Generator().manual_seed(2))
    boxes, scores = boxes.to(dev), scores.to(dev)
    checks, err, timed = [], 0, {}
    for name, (b, s) in k2_pools(torch, boxes, scores).items():
        ri, rv = nms_cuda.nms_greedy_reference(b, s, thr, max_det)
        stats = torch.zeros(B, 4, dtype=torch.int32, device=dev)
        ki, kv = nms_cuda.nms_greedy(b, s, thr, max_det, stats=stats)
        torch.cuda.synchronize()
        rounds = stats[:, 0].tolist()
        checks.append({
            "pool": name,
            "identical": bool(torch.equal(ri, ki) and torch.equal(rv, kv)),
            "scan_as_expected": bool(torch.equal(
                stats, expected_scan(torch, s, ri, rv, max_det))),
            "kept": int(kv.sum()), "max_rounds": max(rounds),
            "mean_rounds": sum(rounds) / len(rounds),
            "mean_consumed": stats[:, 1].float().mean().item()})
        err = max(err, int((ki - ri).abs().max()))
        if name in ("unsorted", "few_survive"):
            bound_ms, bound_by = k2_bound(stats, B, K, max_det)
            timed[name] = {
                "kept": int(kv.sum()),
                "ms": time_ms(lambda: nms_cuda.nms_greedy(b, s, thr,
                                                          max_det)),
                "device_ms": device_ms(lambda: nms_cuda.nms_greedy(
                    b, s, thr, max_det)),
                "bound_ms": bound_ms, "bound_by": bound_by}
    rec = {"max_abs_err": err, **timed["unsorted"],
           "identical": all(c["identical"] for c in checks),
           "scan_as_expected": all(c["scan_as_expected"] for c in checks),
           "checks": checks, "few_survive": timed["few_survive"],
           "plain_ms": time_ms(lambda: nms_cuda.nms_greedy_reference(
               boxes, scores, thr, max_det), warmup=1),
           "library_ms": None}
    emit({"phase": "k2_nms_greedy", **rec})
    if not rec["identical"]:
        raise AssertionError(f"K2 keep_idx/keep_valid differ from the plain "
                             f"version: {checks}")
    if not rec["scan_as_expected"]:
        raise AssertionError(f"K2's count of its scan differs from the "
                             f"sorted pool's: {checks}")
    return rec


# ------------------------------------------------------------------ phase 6
def time_f32_library(torch, fn) -> float:
    """``time_ms`` of a cuDNN call in true f32 (TF32 off, as the f32
    comparisons run)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return time_ms(fn)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def phase_k3(torch, dev):
    import copy

    from mmidet_tpu_torch.nn import cem_cuda
    from mmidet_tpu_torch.nn.cem import ContourEnhance
    gen = torch.Generator().manual_seed(6)

    def rn(*shape, scale, base=0.0):
        return (base + scale * torch.randn(*shape, generator=gen)).to(dev)
    # JAX layouts (HWIO); biases nonzero so that zero padding against bias
    # shows at the borders
    params = (rn(3, 3, 3, 24, scale=0.3), rn(24, scale=0.5),
              rn(24, scale=0.4, base=1.0), rn(24, scale=0.5),
              rn(3, 3, 24, 3, scale=0.2), rn(3, scale=0.5))
    B, S = 16, 640
    checks, main = [], None
    for shape, dtype in (((B, S, S, 3), torch.bfloat16),
                         ((B, S, S, 3), torch.float32),
                         ((2, 352, 608, 3), torch.bfloat16),
                         ((2, 352, 608, 3), torch.float32)):
        x = torch.rand(*shape, generator=gen).to(dev, dtype)
        ref = cem_cuda.fused_cem_reference(x, *params).float()
        out = cem_cuda.fused_cem(x, *params).float()
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = float((out - ref).abs().max())
        top = float(ref.abs().max())
        ok = err <= K3_TOL[name] * top
        checks.append({"shape": list(shape), "dtype": name,
                       "max_abs_err": err, "max_abs_ref": top,
                       "tol": K3_TOL[name], "ok": ok})
        if main is None:
            main = x
        del ref, out
    x = main
    # the same function from the port's unfused module (cuDNN convolutions),
    # bf16, on the same input and weights: the library yardstick
    mod = ContourEnhance(3, fused=True).to(dev)
    with torch.no_grad():
        mod.conv2.weight.copy_(params[0].permute(3, 2, 0, 1))
        mod.conv2.bias.copy_(params[1])
        mod.sobel.sobel_factor.copy_(params[2].view(-1, 1, 1, 1))
        mod.sobel.bias.copy_(params[3])
        mod.conv3.weight.copy_(params[4].permute(3, 2, 0, 1))
        mod.conv3.bias.copy_(params[5])
    mod32 = copy.deepcopy(mod).eval()  # the f32 form's library yardstick
    mod = mod.to(torch.bfloat16).eval()
    x_nchw = x.permute(0, 3, 1, 2)
    x32 = x.float()
    pix = B * S * S
    # per pixel: conv2 1296, channel sum 24, bank 144, tile x factor + bias
    # 48, y + e 24, conv3 1296, residual 3
    flops = pix * (1296 + 24 + 144 + 48 + 24 + 1296 + 3)
    nbytes = pix * 3 * 2 * 2 + 1660 * 4
    # the bf16 form's products take bf16 operands: the tensor cores' rate,
    # on which the kernel runs them; the f32 form's take f32
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    f32_bound_ms, f32_bound_by = bound(flops, pix * 3 * 4 * 2 + 1660 * 4,
                                       PEAK_F32_FLOPS)
    # the module keeps the packed weights between forwards (nn/cem.py):
    # "ms" is timed so, "ms_with_packing" packs them in every call
    pack = cem_cuda.pack_cem_weights(*params, x.dtype)
    pack32 = cem_cuda.pack_cem_weights(*params, x32.dtype)
    with torch.inference_mode():
        lib = mod(x_nchw).permute(0, 2, 3, 1).float()
        rec = {"shape": [B, S, S, 3], "dtype": "bfloat16",
               "max_abs_err": max(c["max_abs_err"] for c in checks
                                  if c["dtype"] == "bfloat16"),
               "library_max_abs_err": float(
                   (lib - cem_cuda.fused_cem_reference(x, *params).float())
                   .abs().max()),
               "ms": time_ms(
                   lambda: cem_cuda.fused_cem(x, *params, pack=pack)),
               "device_ms": device_ms(
                   lambda: cem_cuda.fused_cem(x, *params, pack=pack)),
               "ms_with_packing": time_ms(
                   lambda: cem_cuda.fused_cem(x, *params)),
               "plain_ms": time_ms(
                   lambda: cem_cuda.fused_cem_reference(x, *params), reps=5,
                   warmup=1),
               "library_ms": time_ms(lambda: mod(x_nchw)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "f32_form": {
                   "ms": time_ms(lambda: cem_cuda.fused_cem(
                       x32, *params, pack=pack32)),
                   "device_ms": device_ms(lambda: cem_cuda.fused_cem(
                       x32, *params, pack=pack32)),
                   "plain_ms": time_ms(
                       lambda: cem_cuda.fused_cem_reference(x32, *params),
                       reps=5, warmup=1),
                   "library_ms": time_f32_library(
                       torch, lambda: mod32(x32.permute(0, 3, 1, 2))),
                   "bound_ms": f32_bound_ms, "bound_by": f32_bound_by},
               "checks": checks, "ok": all(c["ok"] for c in checks)}
    emit({"phase": "k3_fused_cem", **rec})
    if not rec["ok"]:
        raise AssertionError(f"K3 disagrees with its plain version: {checks}")
    return rec


# ------------------------------------------------------------------ phase 7
def library_merge(torch, rgb, ir, st, pos, lns, lnb, heads, gate):
    """The same function from PyTorch's own operators, bf16, on NCHW views
    of the NHWC streams: a yardstick, never called by the port."""
    import torch.nn.functional as F
    r, i = rgb.permute(0, 3, 1, 2), ir.permute(0, 3, 1, 2)
    b, c, h, w = r.shape
    rp, ip = F.adaptive_avg_pool2d(r, 8), F.adaptive_avg_pool2d(i, 8)
    if gate is not None:
        g1, g2 = gate
        rp = F.conv2d(torch.sigmoid(F.conv2d(rp, g1)), g2) * rp
        ip = F.conv2d(torch.sigmoid(F.conv2d(ip, g1)), g2) * ip
    tok = torch.cat([rp.flatten(2).transpose(1, 2),
                     ip.flatten(2).transpose(1, 2)], 1) + pos
    z = F.layer_norm(library_transformer(tok, st, heads), (c,), lns, lnb,
                     1e-5)
    zr = z[:, :64].transpose(1, 2).reshape(b, c, 8, 8)
    zi = z[:, 64:].transpose(1, 2).reshape(b, c, 8, 8)
    return (r + F.interpolate(zr, size=(h, w), mode="bilinear",
                              align_corners=False),
            i + F.interpolate(zi, size=(h, w), mode="bilinear",
                              align_corners=False))


def phase_k4(torch, dev):
    from mmidet_tpu_torch.nn import fusion_cuda as fc
    from mmidet_tpu_torch.nn.transformer_cuda import prepare_stack
    B, L, heads = 16, 8, 8
    gen = torch.Generator().manual_seed(7)
    bf16 = torch.bfloat16
    levels = []
    for d, hw, gated in LEVELS:
        rgb = torch.randn(B, hw, hw, d, generator=gen).to(dev, bf16)
        ir = (0.3 * torch.randn(B, hw, hw, d, generator=gen) + 0.2).to(
            dev, bf16)
        st = random_stack(d, L, gen, dev)
        pos = (0.2 * torch.randn(1, 128, d, generator=gen)).to(dev)
        lns = (1 + 0.2 * torch.randn(d, generator=gen)).to(dev)
        lnb = (0.2 * torch.randn(d, generator=gen)).to(dev)
        gate = lib_gate = None
        if gated:
            gate = {"g1": (torch.randn(d, 8, generator=gen)
                           / math.sqrt(d)).to(dev),
                    "g2": (torch.randn(8, d, generator=gen)
                           / math.sqrt(8)).to(dev)}
            lib_gate = (gate["g1"].T.reshape(8, d, 1, 1).to(bf16),
                        gate["g2"].T.reshape(d, 8, 1, 1).to(bf16))
        args = (rgb, ir, st, pos, lns, lnb, heads, gate)
        kept = (rgb, ir, prepare_stack(st, dev), pos, lns, lnb, heads, gate)
        ref = fc.fused_gpt_merge_reference(*args)
        out = fc.fused_gpt_merge(*args)
        torch.cuda.synchronize()
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(out, ref))
        top = max(float(r.float().abs().max()) for r in ref)
        ok = err <= K4_TOL * top
        lib_args = (rgb, ir, library_stack(torch, st), pos.to(bf16),
                    lns.to(bf16), lnb.to(bf16), heads, lib_gate)
        lib = library_merge(torch, *lib_args)
        lib_err = max(float((o.permute(0, 2, 3, 1).float() - r.float())
                            .abs().max()) for o, r in zip(lib, ref))
        del ref, out, lib
        # bytes: both streams read once and written once, the weights once;
        # operations: K1's, plus per stream element one add for the pool, 9
        # for the interpolation and one for the sum, and the gate's two
        # products; all on bf16 operands
        k1_flops, k1_bytes = k1_work(B, L, 128, d)
        elem = 2 * B * hw * hw * d
        flops = k1_flops + elem * 11 + (B * 128 * d * 8 * 4 if gated else 0)
        nbytes = 2 * elem * 2 + k1_bytes
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        rec = {"d": d, "hw": hw, "gated": gated, "max_abs_err": err,
               "max_abs_ref": top, "library_max_abs_err": lib_err,
               "ms": time_ms(lambda: fc.fused_gpt_merge(*kept)),
               "device_ms": device_ms(lambda: fc.fused_gpt_merge(*kept)),
               "ms_with_stacking": time_ms(
                   lambda: fc.fused_gpt_merge(*args)),
               "plain_ms": time_ms(
                   lambda: fc.fused_gpt_merge_reference(*args), reps=5,
                   warmup=1),
               "library_ms": time_ms(
                   lambda: library_merge(torch, *lib_args)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9,
               "mbytes": nbytes / 1e6, "ok": ok}
        emit({"phase": "k4_fused_gpt_merge", **rec})
        if not ok:
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"d={d}: max |err| {err} at |ref| {top}")
        levels.append(rec)
        del rgb, ir, args, kept, lib_args
    return levels


# -------------------------------------------------------------- phases 8, 9
def build_model(torch, spec, seed: int = 0, **flags):
    """Seeded torch init; the fusion transformers' LN and bias parameters
    (and pos-emb) randomised to normal * 0.2, as the JAX package's kernel
    tests do; then BN folded.  ``flags`` are the detector's kernel flags
    (default: ``kernel_fusion`` alone)."""
    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.nn.fuse import fold_batchnorm
    from mmidet_tpu_torch.nn.fusion import _TokenTransformer
    torch.manual_seed(seed)
    model = TwoStreamDetector(spec, **(flags or {"kernel_fusion": True}))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _TokenTransformer):
                for name, p in mod.named_parameters():
                    if p.dim() == 1 or name == "pos_emb":
                        p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return fold_batchnorm(model).eval()


def set_kernel_flags(model, kernel_fusion: bool, kernel_cem: bool,
                     kernel_merge: bool) -> None:
    """Switch a built detector between its kernel routes (same weights)."""
    model.Enhance.use_kernel = kernel_cem
    for mod in model.modules():
        if hasattr(mod, "merge_kernel"):
            mod.use_kernel, mod.merge_kernel = kernel_fusion, kernel_merge


def counters():
    from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda, transformer_cuda
    from mmidet_tpu_torch.ops import nms_cuda
    return {"fused_token_transformer":
            transformer_cuda.fused_token_transformer,
            "nms_greedy": nms_cuda.nms_greedy,
            "fused_cem": cem_cuda.fused_cem,
            "fused_gpt_merge": fusion_cuda.fused_gpt_merge}


def png(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def phase_path(torch, dev, card: str, phase: str, vs_phase: str,
               model_name: str, flags, want_launches, alt_flags=None,
               reps: int = 10):
    """Drive one model end to end: forward + NMS at batch 16, 640x640, bf16
    through the kernels (launches counted from 0 and asserted), the same
    path in f32 against the plain versions on the CPU, and three service
    requests.  ``alt_flags``: a second kernel route of the same model,
    timed in turns with the first."""
    import copy

    import numpy as np

    from mmidet_tpu_torch.deploy.serve import DetectionService
    from mmidet_tpu_torch.models.zoo import get_model_spec
    from mmidet_tpu_torch.ops.nms import non_max_suppression

    spec = get_model_spec(model_name)
    B, S, small_img = 16, 640, 320
    model = build_model(torch, spec, **flags)
    f32_model = copy.deepcopy(model)
    model = model.to(dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(B, S, S, 3, generator=gen, device=dev)
    ir = torch.rand(B, S, S, 3, generator=gen, device=dev)

    def forward():
        return model(rgb, ir)["pred"]

    def nms(pred):
        return non_max_suppression(pred.float(), conf_thres=0.001,
                                   iou_thres=0.45)

    with torch.inference_mode():
        nms(forward())  # warm-up (first launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters().values():
            fn.launches = 0
        pred = forward()
        dets, valid = nms(pred)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters().items()}
        if launches != want_launches:
            raise AssertionError(f"{model_name} missed its kernels: "
                                 f"{launches}, expected {want_launches}")
        n_box = sum(3 * (S // s) ** 2 for s in spec.strides)
        if tuple(pred.shape) != (B, n_box, 5 + spec.nc) or \
                not bool(torch.isfinite(pred).all()) or \
                not bool(torch.isfinite(dets).all()):
            raise AssertionError(f"bad output of {model_name}: "
                                 f"{tuple(pred.shape)}")
        conf = pred[..., 4:5].float() * pred[..., 5:].float()
        pool = int((conf.amax(-1) > 0.001).sum(1).min())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fwd = {"kernels": []}
        if alt_flags is None:
            fwd["kernels"].append(time_ms(forward, reps=reps, warmup=1))
        else:  # in turns: kernels, other route, other route, kernels
            fwd["other"] = []
            for which in ("kernels", "other", "other", "kernels"):
                set_kernel_flags(model, **{
                    "kernel_fusion": False, "kernel_cem": False,
                    "kernel_merge": False,
                    **(flags if which == "kernels" else alt_flags)})
                fwd[which].append(time_ms(forward, reps=reps, warmup=2))
        fwd_ms = statistics.mean(fwd["kernels"])
        nms_ms = time_ms(lambda: nms(pred), reps=reps, warmup=1)
    rec = {"phase": phase, "model": model_name, "batch": B, "img": S,
           "dtype": "bfloat16", "card": card, "flags": flags,
           "launches_per_forward": launches,
           "min_candidates_above_conf": pool,
           "kept_per_image": float(valid.sum(1).float().mean()),
           "forward_ms_per_batch": fwd_ms, "nms_ms_per_batch": nms_ms,
           "forward_img_per_s": B / fwd_ms * 1e3,
           "nms_img_per_s": B / nms_ms * 1e3,
           "forward_nms_img_per_s": B / (fwd_ms + nms_ms) * 1e3,
           "forward_ms_per_img": fwd_ms / B, "nms_ms_per_img": nms_ms / B,
           "peak_mem_gb": peak_gb}
    emit(rec)
    if alt_flags is not None:
        other_ms = statistics.mean(fwd["other"])
        emit({"phase": phase + "_other_route", "model": model_name,
              "flags": alt_flags, "order": "kernels, other, other, kernels",
              "forward_ms_per_batch_kernels": fwd["kernels"],
              "forward_ms_per_batch_other": fwd["other"],
              "forward_ms_per_batch": other_ms,
              "forward_img_per_s": B / other_ms * 1e3,
              "kernels_over_other": fwd_ms / other_ms})

    # the same path in f32 against the plain versions on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = torch.rand(2, small_img, small_img, 6, generator=torch.Generator()
                       .manual_seed(4))
    with torch.inference_mode():
        cpu_pred = f32_model(small[..., :3], small[..., 3:])["pred"]
        gpu_model = copy.deepcopy(f32_model).to(dev)
        gpu_pred = gpu_model(small[..., :3].to(dev),
                             small[..., 3:].to(dev))["pred"]
        d_cpu, v_cpu = non_max_suppression(gpu_pred.cpu(), conf_thres=0.001)
        d_gpu, v_gpu = non_max_suppression(gpu_pred, conf_thres=0.001)
    err = float((gpu_pred.cpu() - cpu_pred).abs().max())
    close = bool(torch.allclose(gpu_pred.cpu(), cpu_pred, rtol=PATH_TOL,
                                atol=PATH_TOL))
    nms_same = bool(torch.equal(v_cpu, v_gpu.cpu())
                    and torch.allclose(d_cpu, d_gpu.cpu(), atol=1e-5,
                                       rtol=0))
    emit({"phase": vs_phase, "model": model_name,
          "dtype": "float32", "img": small_img, "batch": 2,
          "pred_max_abs_err": err,
          "pred_max_abs": float(cpu_pred.abs().max()), "tol": PATH_TOL,
          "pred_close": close, "nms_identical": nms_same,
          "kept": int(v_gpu.sum())})
    if not (close and nms_same):
        raise AssertionError(f"{model_name}: the kernel path disagrees with "
                             f"the plain path")
    del gpu_model, f32_model

    svc = DetectionService(model, [str(i) for i in range(spec.nc)],
                           img_size=S, conf_thres=0.001, device=dev)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    counts = []
    for h, w in ((512, 640), (640, 480), (600, 600)):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        recs = svc.predict(png(img), png(255 - img))
        keys = {"xmin", "ymin", "xmax", "ymax", "confidence", "class",
                "name"}
        if not isinstance(recs, list) or not all(
                set(r) == keys and 0 <= r["class"] < spec.nc
                and all(math.isfinite(r[k]) for k in keys - {"name"})
                for r in recs):
            raise AssertionError("malformed detection records")
        counts.append(len(recs))
    emit({"phase": "service", "model": model_name, "requests": 3,
          "records": counts, "seconds": time.perf_counter() - t0})
    del svc, model
    torch.cuda.empty_cache()
    return launches


def summed(recs, key):
    return sum(r[key] for r in recs)


def majority_bound(recs):
    ops = sum(r["bound_by"] == "operations" for r in recs)
    return "operations" if 2 * ops > len(recs) else "bytes"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "mmidet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(mmidet_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mmidet_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    # the plain versions and the f32 comparisons run in true f32
    torch.backends.cuda.matmul.allow_tf32 = False

    secs = kernels.build_all()
    regs = [ln.strip() for n in kernels.LIBRARIES
            for ln in kernels.build_log(n).splitlines() if "Used" in ln]
    emit({"phase": "build", "seconds": secs,
          "libraries": list(kernels.LIBRARIES), "ptxas": regs})

    phase_layer_gemm(torch, dev, card)
    k1 = phase_k1(torch, dev)
    k2 = phase_k2(torch, dev)
    k3 = phase_k3(torch, dev)
    k4 = phase_k4(torch, dev)
    first = phase_path(
        torch, dev, name, "main_path", "main_path_vs_plain", "yolov5s_gpt4",
        {"kernel_fusion": True},
        {"fused_token_transformer": 4, "nms_greedy": 1, "fused_cem": 0,
         "fused_gpt_merge": 0}, reps=5)
    flagship = phase_path(
        torch, dev, name, "flagship_path", "flagship_vs_plain",
        "yolov5l_fuse3_fourier",
        {"kernel_cem": True, "kernel_merge": True},
        {"fused_cem": 1, "fused_gpt_merge": 4, "fused_token_transformer": 0,
         "nms_greedy": 1}, alt_flags={"kernel_fusion": True})

    # K1's row sums the four levels of the yolov5s_gpt4 forward
    k1_path = [r for r in k1 if r["d"] <= 512]
    shape_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "max_abs_err")
    summary = {"kernels": [
        {"name": "fused_token_transformer", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/token_transformer.cu",
         "replaces": "mmidet_tpu/nn/transformer_pallas.py:218",
         "launches": first["fused_token_transformer"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": summed(k1_path, "ms"), "plain_ms": summed(k1_path, "plain_ms"),
         "bound_ms": summed(k1_path, "bound_ms"),
         "bound_by": majority_bound(k1_path),
         "library_ms": summed(k1_path, "library_ms"),
         "per_shape": [{k: r[k] for k in ("d",) + shape_keys} for r in k1]},
        {"name": "nms_greedy", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/nms_greedy.cu",
         "replaces": "mmidet_tpu/ops/nms_pallas.py:82",
         "launches": flagship["nms_greedy"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "fused_cem", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/cem.cu",
         "replaces": "mmidet_tpu/nn/cem_pallas.py:280",
         "launches": flagship["fused_cem"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]},
        # K4's row sums the four levels of the flagship forward
        {"name": "fused_gpt_merge", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/gpt_merge.cu",
         "replaces": "mmidet_tpu/nn/fusion_pallas.py:298",
         "launches": flagship["fused_gpt_merge"],
         "max_abs_err": max(r["max_abs_err"] for r in k4),
         "ms": summed(k4, "ms"), "plain_ms": summed(k4, "plain_ms"),
         "bound_ms": summed(k4, "bound_ms"),
         "bound_by": majority_bound(k4),
         "library_ms": summed(k4, "library_ms"),
         "per_shape": [{k: r[k] for k in ("d", "hw", "gated") + shape_keys}
                       for r in k4]}]}
    emit(summary)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
