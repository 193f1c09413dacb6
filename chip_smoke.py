#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmidet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from ``mmidet_tpu_torch/csrc`` (nvcc);
  3. K1, the fused token transformer, against its plain PyTorch version at
     the main path's shapes (B = 16, 128 tokens, L = 8, d = 64..512), with
     kernel, plain, library (torch.matmul + SDPA) and bound times;
  4. K2, greedy NMS, against its plain version (B = 16, K = 4096,
     max_det = 300): identical indices;
  5. the main path: yolov5s_gpt4 at full width and depth, seeded random
     weights, BN folded, bf16, batch 16 at 640x640, forward + NMS through
     the kernels (launch counts asserted), throughput; the same path in f32
     against the plain versions on the CPU at a small input; then
     ``DetectionService`` answers 3 requests;
  6. the ``kernels`` summary line, the card line, and the final
     ``{"ok": true, "device": ...}`` line.
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
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# K1: max |kernel - plain| <= 2% of max |plain|.  The two differ only in
# the order of f32 sums, but every layer rounds to bf16 (2^-8 relative) at
# six points, so one flipped rounding compounds through 8 dependent layers.
K1_TOL = 0.02
PATH_TOL = 2e-2                 # f32 model, kernels vs plain versions


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


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phase 3
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


def phase_k1(torch, dev):
    from mmidet_tpu_torch.nn import transformer_cuda as tc
    B, L, heads, n = 16, 8, 8, tc.TOKENS
    gen = torch.Generator().manual_seed(1)
    shapes = []
    for d in (64, 128, 256, 512):
        x = torch.randn(B, n, d, generator=gen).to(dev, torch.bfloat16)
        st = random_stack(d, L, gen, dev)
        ref = tc.fused_token_transformer_reference(x, st, heads).float()
        out = tc.fused_token_transformer(x, st, heads).float()
        torch.cuda.synchronize()
        err = (out - ref).abs()
        ok = bool(err.max() <= K1_TOL * ref.abs().max())
        lib_st = {k: v.to(torch.bfloat16) for k, v in st.items()}
        lib_st["wqkv"] = torch.cat([lib_st["wq"], lib_st["wk"],
                                    lib_st["wv"]], 1)
        lib_st["bqkv"] = torch.cat([lib_st["bq"], lib_st["bk"],
                                    lib_st["bv"]], 1)
        lib = library_transformer(x, lib_st, heads).float()
        flops = L * B * (24 * n * d * d + 4 * n * n * d)
        nbytes = L * 12 * d * d * 2 + 2 * B * n * d * 2
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        rec = {
            "d": d, "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "max_abs_ref": float(ref.abs().max()),
            "library_max_abs_err": float((lib - ref).abs().max()),
            "ms": time_ms(lambda: tc.fused_token_transformer(x, st, heads)),
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


# ------------------------------------------------------------------ phase 4
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


def phase_k2(torch, dev):
    from mmidet_tpu_torch.ops import nms_cuda
    B, K, max_det, thr = 16, 4096, 300, 0.45
    boxes, scores = nms_pool(torch, B, K, torch.Generator().manual_seed(2))
    boxes, scores = boxes.to(dev), scores.to(dev)
    ri, rv = nms_cuda.nms_greedy_reference(boxes, scores, thr, max_det)
    ki, kv = nms_cuda.nms_greedy(boxes, scores, thr, max_det)
    torch.cuda.synchronize()
    same = bool(torch.equal(ri, ki) and torch.equal(rv, kv))
    steps = int(kv.sum())  # steps that found a box; the rest exit early
    flops = steps * K * 14  # compare + 13 f32 operations of the IoU pass
    nbytes = B * K * (16 + 4) + B * max_det * (4 + 1)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    rec = {"max_abs_err": float((ki - ri).abs().max()), "identical": same,
           "kept": steps,
           "ms": time_ms(lambda: nms_cuda.nms_greedy(boxes, scores, thr,
                                                     max_det)),
           "plain_ms": time_ms(lambda: nms_cuda.nms_greedy_reference(
               boxes, scores, thr, max_det), warmup=1),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "k2_nms_greedy", **rec})
    if not same:
        raise AssertionError("K2 keep_idx/keep_valid differ from the plain "
                             "version")
    return rec


# ------------------------------------------------------------------ phase 5
def build_model(torch, spec, seed: int = 0):
    """Seeded torch init; the fusion transformers' LN and bias parameters
    (and pos-emb) randomised to normal * 0.2, as the JAX package's kernel
    tests do; then BN folded."""
    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.nn.fuse import fold_batchnorm
    from mmidet_tpu_torch.nn.fusion import CrossModalTransformer
    torch.manual_seed(seed)
    model = TwoStreamDetector(spec, kernel_fusion=True)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, CrossModalTransformer):
                for name, p in mod.named_parameters():
                    if p.dim() == 1 or name == "pos_emb":
                        p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return fold_batchnorm(model).eval()


def png(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def phase_main(torch, dev, name: str):
    import copy

    import numpy as np

    from mmidet_tpu_torch.deploy.serve import DetectionService
    from mmidet_tpu_torch.models.zoo import two_stream_spec
    from mmidet_tpu_torch.nn import transformer_cuda as tc
    from mmidet_tpu_torch.ops import nms_cuda
    from mmidet_tpu_torch.ops.nms import non_max_suppression

    spec = two_stream_spec("s", "gpt4", nc=6)
    B, S, small_img = 16, 640, 320
    model = build_model(torch, spec)
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
        tc.fused_token_transformer.launches = 0
        nms_cuda.nms_greedy.launches = 0
        pred = forward()
        dets, valid = nms(pred)
        torch.cuda.synchronize()
        launches = {"fused_token_transformer":
                    tc.fused_token_transformer.launches,
                    "nms_greedy": nms_cuda.nms_greedy.launches}
        if launches != {"fused_token_transformer": 4, "nms_greedy": 1}:
            raise AssertionError(f"main path missed its kernels: {launches}")
        n_box = sum(3 * (S // s) ** 2 for s in spec.strides)
        if tuple(pred.shape) != (B, n_box, 11) or \
                not bool(torch.isfinite(pred).all()) or \
                not bool(torch.isfinite(dets).all()):
            raise AssertionError(f"bad main-path output {tuple(pred.shape)}")
        conf = pred[..., 4:5].float() * pred[..., 5:].float()
        pool = int((conf.amax(-1) > 0.001).sum(1).min())
        fwd_ms = time_ms(forward, reps=10, warmup=1)
        nms_ms = time_ms(lambda: nms(pred), reps=10, warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "main_path", "model": "yolov5s_gpt4", "batch": B,
          "img": S, "dtype": "bfloat16", "card": name,
          "launches_per_forward": launches,
          "min_candidates_above_conf": pool,
          "kept_per_image": float(valid.sum(1).float().mean()),
          "forward_ms_per_batch": fwd_ms, "nms_ms_per_batch": nms_ms,
          "forward_img_per_s": B / fwd_ms * 1e3,
          "nms_img_per_s": B / nms_ms * 1e3,
          "forward_nms_img_per_s": B / (fwd_ms + nms_ms) * 1e3,
          "forward_ms_per_img": fwd_ms / B, "nms_ms_per_img": nms_ms / B,
          "peak_mem_gb": peak_gb})

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
    emit({"phase": "main_path_vs_plain", "dtype": "float32",
          "img": small_img, "batch": 2, "pred_max_abs_err": err,
          "pred_max_abs": float(cpu_pred.abs().max()), "tol": PATH_TOL,
          "pred_close": close, "nms_identical": nms_same,
          "kept": int(v_gpu.sum())})
    if not (close and nms_same):
        raise AssertionError("kernel path disagrees with the plain path")
    del gpu_model, f32_model

    svc = DetectionService(model, [str(i) for i in range(6)], img_size=S,
                           conf_thres=0.001, device=dev)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    counts = []
    for h, w in ((512, 640), (640, 480), (600, 600)):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        recs = svc.predict(png(img), png(255 - img))
        keys = {"xmin", "ymin", "xmax", "ymax", "confidence", "class",
                "name"}
        if not isinstance(recs, list) or not all(
                set(r) == keys and 0 <= r["class"] < 6
                and all(math.isfinite(r[k]) for k in keys - {"name"})
                for r in recs):
            raise AssertionError("malformed detection records")
        counts.append(len(recs))
    emit({"phase": "service", "requests": 3, "records": counts,
          "seconds": time.perf_counter() - t0})
    return launches


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
    torch.backends.cuda.matmul.allow_tf32 = False

    secs = kernels.build_all()
    regs = [ln.strip() for n in kernels.SIGNATURES
            for ln in kernels.build_log(n).splitlines() if "Used" in ln]
    emit({"phase": "build", "seconds": secs, "ptxas": regs})

    k1 = phase_k1(torch, dev)
    k2 = phase_k2(torch, dev)
    launches = phase_main(torch, dev, name)

    def total(key):
        return sum(r[key] for r in k1)

    summary = {"kernels": [
        {"name": "fused_token_transformer", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/token_transformer.cu",
         "replaces": "mmidet_tpu/nn/transformer_pallas.py:218",
         "launches": launches["fused_token_transformer"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": total("ms"), "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"),
         "bound_by": ("operations" if sum(r["bound_by"] == "operations"
                                          for r in k1) > 2 else "bytes"),
         "library_ms": total("library_ms"),
         "per_shape": [{k: r[k] for k in ("d", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                       for r in k1]},
        {"name": "nms_greedy", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/nms_greedy.cu",
         "replaces": "mmidet_tpu/ops/nms_pallas.py:82",
         "launches": launches["nms_greedy"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None}]}
    emit(summary)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
