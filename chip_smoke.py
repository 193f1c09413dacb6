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
     duplicate boxes and one of which few boxes survive, unsorted and
     sorted; the kernel's own count of its scan per image (dependent
     steps, consumed, kept, valid, path), held against what greedy's
     answer determines; timed on the seeded pool, the sorted one and both
     of few survivors; then the same pools at K = 30000, the evaluator's
     ``pre_nms_topk``, which K2's large-pool form (a cluster of eight
     blocks per image) takes, each pool's paths as the kernel recorded
     them;
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
  10. ``eval_nms``: the evaluator's NMS (``pre_nms_topk=30000``,
     ``multi_label=True``, conf 0.001) on the flagship's bf16 predictions
     through K2's large-pool form, identical to the same function with
     greedy's plain version; every image's pool, ``torch.topk``'s output,
     takes the large form's in-order path;
  11. ``eval_path``: the evaluation path as a user runs it, on data
     written while nvcc builds (joined before phase 3): 64 square pairs
     at 640 (``make_synthetic_pair_dataset``) and the same pairs resized
     to 640x512.  The flagship from ``cli.val.load_model_and_vars``
     (seeded init, BN folded, bf16, K3 + K4), ``evaluate`` at the val
     CLI's defaults (batch 32, 640, conf 0.001, iou 0.6) over the square
     set (``PairedLoader``), the 640x512 set (``RectLoader``, 544x672
     batches) and one TTA batch; each run twice: first untimed with every
     call of K3, K4 and K2 held against its plain version on its inputs
     (``checked_kernels``; K2's path per image read there), then timed as
     a user runs it, launches counted from 0 (K3 once and K4 four times a
     forward, K2's large form once a batch); then both sets' first 8
     pairs at 320 in f32 (weights conditioned to unit activations,
     ``condition``) through the kernels, through their plain versions and
     through the unfused modules, each route's launches asserted, against
     three gates; then the val CLI once, where ``yaml`` imports;
  12. ``train_path``: ``train`` as a user runs it, on the eval path's 64
     square pairs as train and val set: the flagship at full width and
     depth, 640 px, batch 8 (accumulate 8 to nbs 64), aux losses as the
     reference, CEM on, bf16 autocast, basic augmentation with the default
     hyps, 2 epochs (16 micro-steps, 2 optimizer steps, 2 evaluations of
     the EMA); each micro-step timed (synchronised), the optimizer and EMA
     steps apart, peak memory, the losses per epoch; no kernel launched by
     the train steps; each evaluation run twice on its batches, first with
     every K1 and K2 call held against its plain version, then counted
     from 0 (K1 four times and K2's large form once a batch); the best
     checkpoint through ``cli.val.main``; then ``train_f32_gate``: two f32
     train steps of the flagship at 128 px, batch 2, on the card against
     the CPU from the same weights and batch (autocast and TF32 off,
     dropout p = 0): the loss terms, and the changes of the parameters, BN
     buffers and EMA; then ``mosaic_gate``: the mosaic augmentation
     (``make_batch_augment(640, ..., mosaic=True)``) on a batch of 8 from
     ``MosaicLoader``, card against CPU with the same draws, on the
     default hyp's axis-aligned path and on the general warp (degrees 10,
     shear 2), and its ms a batch; ``train_mosaic_path``: ``train_path``
     with mosaic on, the JAX package's default, through ``MosaicLoader``,
     for one epoch (the loader's waits timed in both); ``train_flags_path``:
     one epoch each of ``quad``, ``multi_scale`` and ``rect`` at 320 px on
     the first 16 pairs (two steps each), the shapes every step saw
     against the option's, each evaluation checked and counted as
     ``train_path``'s; ``remat``: one bf16 micro-step of the flagship at 640, batch
     8, with remat "", "dots" and "full" (ms, peak memory), and in f32 at
     128 px each remat step against the plain one;
  13. ``serve_path``: the serving front end as a user runs it: the
     flagship from ``cli.val.load_model_and_vars`` (bf16, K3 + K4 + K2),
     conditioned, in a ``BatchingService`` (max_batch 16, 3 ms) behind a
     ``ThreadingHTTPServer``, 16 distinct 640x640 JPEG pairs
     (``serve_bench``'s content, shifted); 16 requests at once with every
     kernel call in the dispatcher held against its plain version, then
     each pair alone: the same records; timed through ``serve_bench``'s
     closed loop, on a service at the serve CLI's default confidence
     threshold, at concurrency 1 (32 requests: p50/p99) and 32 (256:
     req/s, p50/p99, batch fill, the dispatcher's ms a batch and busy
     share), launches counted (K3 1 and K4 4 a forward, K2 1 a batch);
  14. ``int8_path``: ``serve --int8``'s calibration (``_calibrate_int8``)
     of that model on 4 of the pairs; the quantized flagship at batch 16
     with every K3, K4 and K2 call checked and the launches counted; its
     predictions against the float deploy's (printed); 16 requests through
     a ``BatchingService`` on it; its forward against the float one, in
     turns;
  15. ``hub_path``: ``hub.yolov5s_gpt4`` on 4 images of 640x512, plainly
     and with TTA (K1 4 a forward, K3 1, K2 1 a call), each call checked,
     the records against the same model's plain versions on the card;
     ``export_deploy_bundle``, ``hub.custom`` and ``attempt_load_ensemble``
     of two bundles, each answering;
  16. ``export_path``: a reference-format checkpoint of the flagship
     (pickled stub ``models.yolo.Model`` objects, fp16, ``model`` and
     ``ema``, from a stub checkout written here) through
     ``cli.val.load_model_and_vars``, the EMA taken and no tensor left at
     its init; ``export_program`` of that deploy model (bf16, K3 + K4,
     batch 16 at 640) to a ``.pt2`` file and back: the graph's custom ops
     (K3 1, K4 4) and the launches of a call, ``pred`` against the eager
     module's (identical, or within two eager runs' spread under
     ``cudnn.deterministic``), NMS through K2, the two timed in turns; one
     K3 and one K4 call through the op against the direct ctypes call;
     the same for yolov5s_gpt4 (K1 4); ``export_onnx`` of the flagship in
     f32 at 640, decoded back, and at 128 run through the numpy runner
     against the port's f32 forward on the card (``ONNX_TOL``); the export
     CLI with ``--onnx --savedmodel --tflite`` on the checkpoint: the
     SavedModel (plain TF ops, ``deploy/tf_proto.py``) and the .tflite
     (builtins only, ``deploy/tflite_fb.py``) of the flagship in f32 at
     640, their export seconds, decoded back by the port's codecs (nodes,
     op histograms, MB); both written again at 128 and run through
     ``deploy/tf_np.py`` against the card's f32 forward through K3 and K4
     (launches asserted: K3 1, K4 4) and its plain route (``ONNX_TOL``);
     then ``export_rows_path``: the SavedModel and .tflite at 640 of
     yolov5x_mamba (full width and depth), the three YAML models of step
     19 and ``ROWS_YAML`` (every other row the JAX detector takes), each
     timed and decoded back (nodes, op histograms, MB), and at 128 run
     through ``tf_np`` against the card's f32 forward, plain and, for
     yolov5x_mamba's CEM, through K3 (one launch asserted);
  17. ``mamba_path``: the mamba family at full width, yolov5x_mamba (four
     MambaFusion levels: pool to 8x8, forward and backward stacks of four
     Mamba layers over the 128 tokens of both streams, the selective scan
     in plain PyTorch), seeded, BN folded, bf16, batch 16 at 640, forward
     + NMS through K2 alone (no K1, K3 or K4 launch), peak memory; each
     MambaFusion level timed alone at its shapes, and the scan's share of
     it; the f32 gate against the CPU at 320; 3 ``DetectionService``
     requests;
  18. ``mamba_train_gate``: ``train_f32_gate`` on yolov5s_mamba (the scan's
     autograd on the card against the CPU's);
  19. ``yaml_path``: three single-stream models from reference-format YAML
     text laid out as Ultralytics YOLOv5 v5.0's ``models/hub/
     yolov3-tiny.yaml`` (nn.MaxPool2d, nn.ZeroPad2d), ``yolov3.yaml``
     (repeated Bottleneck rows) and ``yolov5s-transformer.yaml`` (C3TR),
     through ``models.spec.load_yolo_yaml``: each seeded, BN folded, bf16,
     batch 16 at 640, forward + NMS through K2 (one launch asserted), and
     in f32 at 320 against the CPU;
  20. P1, the conv chain (``tools/_probe_igemm.py``): its entry point
     ``mmidet_tpu_torch.tools.probe_igemm`` at the probe's shapes (batch
     128, 160x160, C = 64 and 128), then batch 16; kernel against plain
     version, with kernel, plain, cuDNN and bound times, TFLOP/s, the
     persistent grid (blocks, tiles, shared memory a block) and ptxas's
     registers and spills;
  21. P2 and P3, the CEM layout probes: the entry points ``probe_cem_r3``
     and ``probe_cem_fb``, each body against its plain version, timed
     beside one PyTorch call of the same function (its error too) and an
     empty launch through the same path (the launch floor), timed in turns
     with each body;
  22. ``train_options_path`` (after ``remat``, on the eval path's first
     16 pairs): ``train`` on the flagship at 320, batch 8, mosaic, 2
     epochs with
     ``image_weights`` (the weights the trainer gave the loader against
     ``labels_to_image_weights`` on the first evaluation's maps, the second
     epoch's base images against ``default_rng(seed + 1).choice``),
     ``bbox_interval=1`` (the media JPEGs), ``use_wandb`` with wandb held
     absent (the run goes on), ``log_artifacts`` and ``upload_dataset``
     into a store under ``EVAL_DATA`` (versions and aliases),
     ``bucket`` through a recording ``gsutil`` stub (``results.txt``
     after each evaluation), ``nosave`` (a 2.5 GB checkpoint a run: a
     call's disk writes are capped); then the run resumed from
     ``wandb-artifact://`` for its third epoch; every evaluation checked
     and counted as ``train_path``'s; seconds an epoch and the loader's
     wait share;
  23. ``evolve_path``: ``cli.train.main(... --evolve 2 --epochs 1)`` on the
     flagship at 320 on the first 16 pairs: each generation's hyp against
     ``mutate`` replayed from seed 0 and within ``META``'s bounds, each
     evaluation checked and counted; seconds a generation;
  24. ``sources_path``: cv2 writes an RGB and an IR MJPG ``.avi`` of 8
     frames at 640x512, PIL 4 JPEG pairs; two ``LoadImages`` in lockstep
     and a ``LoadStreams`` over the two videos feed the flagship from
     ``cli.val.load_model_and_vars`` (conditioned) at batch 1, forward +
     NMS (K3 1, K4 4, K2's small form 1 a frame), every call checked, then
     timed (frames/s); ``feature_heatmap`` at ``l6`` and at a fusion row
     against the plain versions on the card (``K4_EVAL_TOL``);
     ``model_cost`` at 640 on the kernel and the plain route (equal
     ``gflops``); ``bench_fn`` beside ``time_ms``; a ``trace`` whose
     Chrome trace names K3's and K4's kernels;
  25. ``aux_experimental_gate``: ``nn/aux_experimental.py``'s modules and
     losses at 64 px in f32, TF32 off, card against CPU (``AUX_TOL``);
  26. ``dp_path``: data and tensor parallelism.  The flagship trains at
     full width, 320 px, global batch 8, f32 with TF32 off, one step from
     one seeded init: (b) on a one-rank NCCL mesh
     (``trainer.train_mesh``), the reference; (a) ``train`` over
     ``[card] * 2`` (gloo ranks sharing the card, data 2) and ``[card] *
     4`` (data 2 x model 2, ``tp_min_out`` 256: the wide layers hold half
     their out channels); each run's metrics of every step (rtol
     ``DP_METRIC_RTOL``) and its parameters, BN statistics and EMA
     (``DP_MOVE_TOL`` over the whole state, ``DP_TENSOR_TOL`` a tensor)
     against the reference, rank 0's evaluation checked
     and counted as ``train_path``'s (K1 4, K2's large form 1 a batch);
     (c) NCCL over two cards only where there are two, else the line
     ``{"nccl_multi_card": "not run: 1 card"}``; (d) ``evaluate`` over
     ``[card, card]`` on 7 val pairs at batch 6 (6, then 1 padded to 2),
     the flagship (K3 1, K4 4 a shard, K2 1 a batch) and yolov5s_gpt4 (K3
     1, K1 4 a shard), launches counted, every call checked against its plain
     version, records and metrics identical to one device's at batch 3
     (the shards' sizes); (e) ``BatchingService`` over ``[card, card]``
     (max_batch 8), 8 requests at once, records identical to one device's
     at max_batch 4;
  27. ``s8_gate_path`` (after ``hub_path``): ``tools/s8_gate.py``'s
     ``train_arm`` and ``gate_record`` at the JAX package's chip settings
     (yolov5s_add, 160 px, 8 pairs, batch 8, f32, ``S8_EPOCHS``): the
     float deploy's and the s8-storage deploy's mAP50 on the same EMA
     weights under the gate protocol, every K2 call of both evaluations
     checked and counted (the gate loader's 192 x 192 batches give pools
     of 4536 boxes: K2's large form); asserts float mAP50 >= 0.5, an ``out_scale`` on
     every fused conv, int8 mAP50 > 0 and delta >= -0.10 (the tool's own
     0.02 verdict printed);
  28. ``resume_path``: a yolov5s_add run at 64 px stopped after the first
     of two epochs, beside a JAX-package run; ``tools.resume_all`` names
     and skips the JAX run and resumes the port's from ``epoch0.pt``'s
     state to the final epoch; a second ``resume_all`` finds nothing;
  29. the ``kernels`` summary line, the card line, and the final
     ``{"ok": true, "device": ...}`` line.
Every path (8-21, 22-24, 26-28) runs with every launch count set to 0
just before it and read just after; a kernel of the path that did not
launch fails the run.  Phases 22-26 run after ``remat`` (step 12), before
``serve_path``; 27 and 28 after ``hub_path`` (step 15).
Times: ``ms`` is a CUDA-event median around each call (the host's time
between launches included, as a caller sees it); ``device_ms`` queues the
call behind a spin kernel so that only the card's time counts.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "mmidet_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke: run it from a checkout of the repository "
             "(mmidet_tpu_torch/ is missing)")
sys.path.insert(0, str(ROOT))
from mmidet_tpu_torch.tools.timing import (  # noqa: E402
    PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound, device_ms, time_ms)

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
# K4 on the eval path's own inputs (the val CLI's seeded init): the streams
# are small next to the final LayerNorm's output, so max |plain| is the
# upsampled transformer output alone and carries all of K1's compounded
# roundings: there the kernel reads up to 3.2% of max |plain| on an H100
# (2% is K4_TOL, phase 7's gate), and on a call's first images it sits no
# further from the plain version than the plain version on the CPU sits
# from itself on the card (2.2%; ``err_same_images`` and
# ``plain_spread``, in every run).  Twice that spread: 5%.  A fault in the
# pooling windows or the interpolation moves values by their own size.
K4_EVAL_TOL = 0.05
# K1 on the trainer's evaluation (the EMA of a few steps from the seeded
# init, K1 at every fusion level): the same situation as K4's layers on
# the eval path, so the same gate; the plain version's own CPU-card spread
# is measured beside it in every run (``plain_spread``)
K1_EVAL_TOL = K4_EVAL_TOL
SPREAD_IMAGES = 4
# the layer GEMM alone: sums in another order flip single bf16 roundings
# (2^-8 of a value), nothing compounds: 1e-2 of max |plain|
GEMM_TOL = 1e-2
PATH_TOL = 2e-2                 # f32 model, kernels vs plain versions
# eval_path, f32, the kernel route against the same model with each kernel
# replaced by its plain version (the same rounding points), on the same
# batches (the bf16 runs hold each kernel call against its plain version
# with K3_TOL / K4_EVAL_TOL, at every shape the path gives it): (1) on the
# synthetic labels, P, R, mAP@.5 and mAP@.5:.95 within 1e-3: sums in
# another order move scores by about 1e-6, which may swap detections of
# near-equal score and move P and R, read off curves interpolated in the
# score, by a little; with random weights these metrics sit near 0 (P
# below 0.006, mAP@.5 below 0.002), so this gate is weak and the two
# below carry the comparison; (2) against the plain versions' 20 best
# detections per image as labels, the kernel route's 20 best at mAP@.5 >=
# 0.95: the same boxes must come out on top, which random weights cannot
# show on the synthetic labels; (3) the predictions before NMS: max |box
# error| over max |box| and max |confidence error| each within 2e-2, the
# f32 path gate's PATH_TOL.  None of the three separates the kernel route
# from the unfused modules (no bf16 rounding in the merges): K4's bf16
# roundings flip with the order of sums and compound through 8 layers, so
# the kernel route sits as far from its plain versions (predictions about
# 0.5%) as from the modules; a fault in a window, a halo or an
# interpolation weight moves values by their own size
EVAL_METRIC_TOL = 1e-3
EVAL_PSEUDO_MAP50 = 0.95
EVAL_PSEUDO_TOP = 20
EVAL_PRED_TOL = PATH_TOL
EVAL_DATA = ROOT / "runs" / "chip_smoke_eval"  # git-ignored; removed after
LEVELS = ((128, 160, True), (256, 80, False), (512, 40, False),
          (1024, 20, False))    # flagship fusion levels at 640: C, H = W, gate


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


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
    scan consumes every valid candidate, unsorted and sorted."""
    _, K = scores.shape
    valid = scores > -torch.inf
    ties = torch.where(valid, torch.floor(scores * 16) / 16, scores)
    top, order = torch.topk(scores, K, 1)

    def in_order(b):
        return b.gather(1, order[..., None].expand(-1, -1, 4))
    dup = boxes.clone()
    dup[:, K // 2:] = boxes[:, :K - K // 2]
    offset = torch.floor(boxes[..., :1] / 4096) * 4096  # the class offset
    xy = 280 + (boxes[..., :2] - offset) / 8  # inside 280..360
    big = torch.cat([xy, xy + 300 + (boxes[..., 2:] - boxes[..., :2]) / 4],
                    -1) + offset
    return {"unsorted": (boxes, scores), "tie_heavy": (boxes, ties),
            "topk_sorted": (in_order(boxes), top),
            "duplicates": (dup, scores), "few_survive": (big, scores),
            "few_survive_sorted": (in_order(big), top)}


def _suppressed(torch, cand, kept, iou_thres: float):
    """Whether any box of ``kept`` (n, 4) suppresses each of ``cand``
    (m, 4), in the plain version's IoU operations (``cand`` the pool
    element, ``kept`` the selected box)."""
    c, k = cand[:, None], kept[None]

    def area(b):
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    xx1 = torch.maximum(c[..., 0], k[..., 0])
    yy1 = torch.maximum(c[..., 1], k[..., 1])
    xx2 = torch.minimum(c[..., 2], k[..., 2])
    yy2 = torch.minimum(c[..., 3], k[..., 3])
    inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
    return (inter / (area(c) + area(k) - inter + 1e-9) > iou_thres).any(1)


def expected_scan(torch, boxes, scores, keep_idx, keep_valid, max_det: int,
                  iou_thres: float, window: int | None = None,
                  chunk: int | None = None):
    """What K2's own count of its scan (``nms_greedy(stats=)``) must read,
    per image, from greedy's result and the scan's rules (window and chunk
    default to the kernel's):
      * consumed: the ordered pool up to the max_det-th kept box, or every
        valid candidate when fewer are kept;
      * rounds: for each window of positions the scan reaches (those
        before ``consumed``), one filter step plus ceil(s / chunk) walk
        steps, s the window's candidates before ``consumed`` that no box
        kept in an earlier window suppresses;
      * kept and valid;
      * path: 0 for K <= SMALL_POOL (the small form); else 1 when the pool
        is in order (scores never rise, invalid slots last); else 2 when
        the selection holds every valid candidate (n_valid <= TOP_CAP) or
        the max_det-th kept box lies in the first TOP positions; else 3."""
    from mmidet_tpu_torch.ops import nms_cuda as k2
    window = window or k2.WINDOW
    chunk = chunk or k2.CHUNK
    B, K = scores.shape
    valid = scores > -torch.inf
    key = torch.where(valid, -scores, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(K, device=order.device).expand_as(
            order).contiguous())
    kept = keep_valid.sum(1)
    n_valid = valid.sum(1)
    last = torch.where(keep_valid, rank.gather(1, keep_idx.long()), -1)
    consumed = torch.where(kept >= max_det, last.amax(1) + 1, n_valid)
    in_order = (key[:, :-1] <= key[:, 1:]).all(1)
    rows = []
    for i in range(B):
        c, nv, nk = int(consumed[i]), int(n_valid[i]), int(kept[i])
        ordered = boxes[i][order[i, :c]]
        kpos = rank[i][keep_idx[i][keep_valid[i]].long()]
        rounds = 0
        for wbase in range(0, c, window):
            cand = ordered[wbase:wbase + window]
            s = len(cand) - int(_suppressed(
                torch, cand, ordered[kpos[kpos < wbase]], iou_thres).sum())
            rounds += 1 + -(-s // chunk)
        if K <= k2.SMALL_POOL:
            path = k2.PATH_SMALL
        elif in_order[i]:
            path = k2.PATH_IN_ORDER
        elif nv <= k2.TOP_CAP or (nk >= max_det and c <= k2.TOP):
            path = k2.PATH_TOP
        else:
            path = k2.PATH_CLUSTER_SORT
        rows.append([rounds, c, nk, nv, path])
    return torch.tensor(rows, dtype=torch.int32, device=scores.device)


def k2_bound(stats, B: int, K: int, max_det: int):
    """K2's bound from what this pool's greedy selection needs: each box
    read and each index written once; the IoUs that decide it (every kept
    box against the kept boxes before it, every other consumed candidate
    against one kept box, 14 f32 operations each) and a comparison sort of
    the valid candidates (n log2 n comparisons)."""
    ops = 0.0
    for _, consumed, kept, n_valid, *_ in stats.tolist():
        ops += 14 * (kept * (kept - 1) / 2 + consumed - kept)
        ops += n_valid * math.log2(max(n_valid, 2))
    return bound(ops, B * K * (16 + 4) + B * max_det * (4 + 1),
                 PEAK_F32_FLOPS)


def phase_k2(torch, dev, K: int = 4096):
    """K2 on the pools of ``k2_pools`` at B = 16 and pool size K: K = 4096
    takes the small form, K = 30000 (the evaluator's ``pre_nms_topk``) the
    large one; each pool's paths as the kernel recorded them."""
    from mmidet_tpu_torch.ops import nms_cuda
    B, max_det, thr = 16, 300, 0.45
    boxes, scores = nms_pool(torch, B, K, torch.Generator().manual_seed(2))
    boxes, scores = boxes.to(dev), scores.to(dev)
    checks, err, timed = [], 0, {}
    for name, (b, s) in k2_pools(torch, boxes, scores).items():
        ri, rv = nms_cuda.nms_greedy_reference(b, s, thr, max_det)
        stats = torch.zeros(B, nms_cuda.STATS_COLUMNS, dtype=torch.int32,
                            device=dev)
        ki, kv = nms_cuda.nms_greedy(b, s, thr, max_det, stats=stats)
        torch.cuda.synchronize()
        rounds = stats[:, 0].tolist()
        paths = stats[:, 4].tolist()
        checks.append({
            "pool": name,
            "identical": bool(torch.equal(ri, ki) and torch.equal(rv, kv)),
            "scan_as_expected": bool(torch.equal(
                stats, expected_scan(torch, b, s, ri, rv, max_det, thr))),
            "kept": int(kv.sum()), "max_rounds": max(rounds),
            "mean_rounds": sum(rounds) / len(rounds),
            "mean_consumed": stats[:, 1].float().mean().item(),
            "paths": {p: paths.count(p) for p in sorted(set(paths))}})
        err = max(err, int((ki - ri).abs().max()))
        if name in ("unsorted", "few_survive", "topk_sorted",
                    "few_survive_sorted"):
            bound_ms, bound_by = k2_bound(stats, B, K, max_det)
            timed[name] = {
                "kept": int(kv.sum()), "mean_rounds": sum(rounds) / B,
                "paths": checks[-1]["paths"],
                "ms": time_ms(lambda: nms_cuda.nms_greedy(b, s, thr,
                                                          max_det)),
                "device_ms": device_ms(lambda: nms_cuda.nms_greedy(
                    b, s, thr, max_det)),
                "bound_ms": bound_ms, "bound_by": bound_by}
    rec = {"pool": K, "max_abs_err": err, **timed.pop("unsorted"),
           "identical": all(c["identical"] for c in checks),
           "scan_as_expected": all(c["scan_as_expected"] for c in checks),
           "checks": checks, **timed,
           "plain_ms": time_ms(lambda: nms_cuda.nms_greedy_reference(
               boxes, scores, thr, max_det), reps=3 if K > 4096 else 20,
               warmup=1),
           "library_ms": None}
    emit({"phase": "k2_nms_greedy" if K <= 4096 else "k2_large_pool", **rec})
    if not rec["identical"]:
        raise AssertionError(f"K2 keep_idx/keep_valid differ from the plain "
                             f"version: {checks}")
    if not rec["scan_as_expected"]:
        raise AssertionError(f"K2's count of its scan differs from the "
                             f"ordered pool's: {checks}")
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
    """Each kernel's launch count: (wrapper, attribute) by name; K2's
    large-pool form counts apart as well as among K2's launches."""
    from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda, transformer_cuda
    from mmidet_tpu_torch.ops import nms_cuda
    from mmidet_tpu_torch.tools import probe_cem_fb, probe_cem_r3, probe_igemm
    return {"fused_token_transformer":
            (transformer_cuda.fused_token_transformer, "launches"),
            "nms_greedy": (nms_cuda.nms_greedy, "launches"),
            "nms_greedy_large": (nms_cuda.nms_greedy, "launches_large"),
            "fused_cem": (cem_cuda.fused_cem, "launches"),
            "fused_gpt_merge": (fusion_cuda.fused_gpt_merge, "launches"),
            "conv_chain": (probe_igemm.conv_chain, "launches"),
            "halo_sum": (probe_cem_r3.halo_sum, "launches"),
            "lane_matmul": (probe_cem_fb.lane_matmul, "launches")}


def zero_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts(**want) -> dict:
    """Every count; with ``want``, raise unless the counts named there are
    as given and every other one is 0."""
    got = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    if want and got != {**{k: 0 for k in got}, **want}:
        raise AssertionError(f"the path missed its kernels: {got}, expected "
                             f"{want} and no other launch")
    return got


def png(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def phase_path(torch, dev, card: str, phase: str, vs_phase: str,
               model_name: str, flags, want_launches, alt_flags=None,
               reps: int = 10, extra=None):
    """Drive one model end to end: forward + NMS at batch 16, 640x640, bf16
    through the kernels (launches counted from 0 and asserted), the same
    path in f32 against the plain versions on the CPU, and three service
    requests.  ``alt_flags``: a second kernel route of the same model,
    timed in turns with the first.  ``extra(model, rgb, ir)``: more of the
    phase's record, measured on the bf16 model and batch after the path's
    run."""
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
        zero_counts()
        pred = forward()
        dets, valid = nms(pred)
        torch.cuda.synchronize()
        launches = read_counts(**want_launches)
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
    if extra is not None:
        rec.update(extra(model, rgb, ir))
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
    return launches, pred


# -------------------------------------------------------------- phase 10
def phase_eval_nms(torch, pred):
    """The evaluator's NMS (``pre_nms_topk=30000, multi_label=True`` at conf
    0.001, ``mmidet_tpu/eval/evaluator.py:56-63``) on the flagship's bf16
    predictions at batch 16: through K2's large-pool form (launch counted
    from 0, each image's path recorded), then the same function with
    greedy's plain version in K2's place on the same pool; the two must be
    identical, and every image must take the in-order path."""
    from unittest import mock

    from mmidet_tpu_torch.ops import nms as nms_mod
    from mmidet_tpu_torch.ops import nms_cuda
    kw = {"conf_thres": 0.001, "iou_thres": 0.45, "multi_label": True,
          "pre_nms_topk": 30000}
    paths = []

    def counted(boxes, scores, iou_thres, max_det):  # K2 with its stats
        stats = torch.zeros(boxes.shape[0], nms_cuda.STATS_COLUMNS,
                            dtype=torch.int32, device=boxes.device)
        out = nms_cuda.nms_greedy(boxes, scores, iou_thres, max_det,
                                  stats=stats)
        paths.extend(stats[:, 4].tolist())
        return out
    with torch.inference_mode():
        zero_counts()
        with mock.patch.object(nms_mod, "nms_greedy", counted):
            dets, valid = nms_mod.non_max_suppression(pred, **kw)
        torch.cuda.synchronize()
        launches = read_counts(nms_greedy=1, nms_greedy_large=1)
        with mock.patch.object(nms_mod, "nms_greedy",
                               nms_cuda.nms_greedy_reference):
            p_dets, p_valid = nms_mod.non_max_suppression(pred, **kw)
            plain_ms = time_ms(lambda: nms_mod.non_max_suppression(
                pred, **kw), reps=3, warmup=1)
        conf = pred[..., 4:5].float() * pred[..., 5:].float()
        rec = {"batch": pred.shape[0], "boxes": pred.shape[1],
               "classes": pred.shape[2] - 5,
               "min_pairs_above_conf": int((conf > 0.001).flatten(1).sum(1)
                                           .min()),
               "identical": bool(torch.equal(valid, p_valid)
                                 and torch.equal(dets, p_dets)),
               "kept_per_image": float(valid.sum(1).float().mean()),
               "paths": {p: paths.count(p) for p in sorted(set(paths))},
               "finite": bool(torch.isfinite(dets).all()),
               "ms": time_ms(lambda: nms_mod.non_max_suppression(pred, **kw),
                             reps=10, warmup=1),
               "plain_ms": plain_ms}
    emit({"phase": "eval_nms", **rec})
    if not (rec["identical"] and rec["finite"]):
        raise AssertionError(f"the evaluator's NMS through K2 differs from "
                             f"its plain path: {rec}")
    if rec["min_pairs_above_conf"] <= 4096:
        raise AssertionError(f"the pool never passed 4096: {rec}")
    if paths != [nms_cuda.PATH_IN_ORDER] * pred.shape[0]:
        raise AssertionError(f"the evaluator's pool, torch.topk's output, "
                             f"did not take K2's in-order path: {rec}")
    return launches


# --------------------------------------------------------------- phase 11
def write_eval_data() -> float:
    """The eval_path phase's two datasets under ``EVAL_DATA``: 64 square
    pairs at 640 (``make_synthetic_pair_dataset``), then the same pairs
    resized to 640x512 with the same labels (YOLO labels are normalized,
    so a resize keeps them), for ``RectLoader``.  Returns the seconds
    taken."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    t0 = time.perf_counter()
    shutil.rmtree(EVAL_DATA, ignore_errors=True)
    square, rect = EVAL_DATA / "square", EVAL_DATA / "rect"
    make_synthetic_pair_dataset(str(square), n=64, img=640, split="val")
    for d in ("val_rgb/images", "val_ir/images"):
        (rect / d).mkdir(parents=True)
    shutil.copytree(square / "val_rgb" / "labels", rect / "val_rgb" / "labels")

    def resized(src: Path) -> None:
        Image.open(src).resize((640, 512), Image.BILINEAR).save(
            rect / src.relative_to(square), compress_level=1)
    with ThreadPoolExecutor(4) as pool:  # PIL's codecs release the GIL
        list(pool.map(resized, sorted(square.glob("val_*/images/*.png"))))
    return time.perf_counter() - t0


def condition(torch, model, rgb, ir) -> None:
    """Layer-sequential unit variance (LSUV, arXiv:1511.06422) on these
    images: in one forward pass, in execution order, every convolution of
    the backbones and the neck is scaled (weight and folded bias) so that
    its output has unit spread; the Detect convs keep their init.  A seeded
    init lets activations fade through the depth, so that every score sits
    within 1e-7 of the Detect prior and the ranking that AP reads is
    rounding noise; after this the scores depend on the image and spread
    apart."""
    head = set(model.model[-1].m)

    def unit(mod, inp, out):
        s = float(out.float().std())
        mod.weight.div_(s)
        mod.bias.div_(s)
        return out / s

    # the fusion blocks' pattern-gate convs (no bias, each applied to both
    # streams), the CEM and the head stay as they are
    hooks = [mod.register_forward_hook(unit)
             for name, mod in model.named_modules()
             if isinstance(mod, torch.nn.Conv2d) and mod.bias is not None
             and mod not in head and not name.startswith("Enhance")]
    with torch.no_grad():
        model(rgb, ir)
    for h in hooks:
        h.remove()


def unprepared(stacked: dict) -> dict:
    """A stack the kernels read (``prepare_stack``: q, k, v joined) as the
    plain versions read it."""
    if "wqkv" not in stacked:
        return stacked
    out = dict(stacked)
    for name, joined in (("w", out.pop("wqkv")), ("b", out.pop("bqkv"))):
        for part, t in zip("qkv", joined.chunk(3, 1)):
            out[name + part] = t
    return out


@contextlib.contextmanager
def plain_versions(torch):
    """The kernels of the model paths (K3, K4, K1, K2) replaced by their
    plain PyTorch versions, on the card: the same rounding points, the
    order of sums aside."""
    from unittest import mock

    from mmidet_tpu_torch.nn import (cem_cuda, fusion, fusion_cuda,
                                     transformer_cuda)
    from mmidet_tpu_torch.ops import nms as nms_mod
    from mmidet_tpu_torch.ops import nms_cuda

    def merge(rgb, ir, stacked, *args, **kw):
        return fusion_cuda.fused_gpt_merge_reference(
            rgb, ir, unprepared(stacked), *args, **kw)

    def cem(x, *params, pack=None):
        return cem_cuda.fused_cem_reference(x, *params)

    def tt(x, stacked, num_heads=8):
        return transformer_cuda.fused_token_transformer_reference(
            x, unprepared(stacked), num_heads)
    with mock.patch.object(fusion, "fused_gpt_merge", merge), \
            mock.patch.object(cem_cuda, "fused_cem", cem), \
            mock.patch.object(fusion, "fused_token_transformer", tt), \
            mock.patch.object(nms_mod, "nms_greedy",
                              nms_cuda.nms_greedy_reference):
        yield


@contextlib.contextmanager
def checked_kernels(torch, checks: list, paths: list):
    """The kernels of the evaluation paths (K3, K4, K2, and K1 on the
    trainer's) each held against its plain version call by call, on the
    inputs the path gives it: K3, K4 and K1 by max |kernel - plain|
    against ``K3_TOL`` / ``K4_EVAL_TOL`` / ``K1_EVAL_TOL`` of max |plain|,
    K2 by identical indices; one record a call into ``checks``
    (K4's and K1's with the plain version's own spread) and K2's
    path per image (``nms_greedy(stats=)``) into ``paths``.  The plain
    versions and the stats read sit in the caller's time: for a run that
    is not timed."""
    import functools
    from unittest import mock

    from mmidet_tpu_torch.nn import (cem_cuda, fusion, fusion_cuda,
                                     transformer_cuda)
    from mmidet_tpu_torch.ops import nms as nms_mod
    from mmidet_tpu_torch.ops import nms_cuda
    merge_kernel, cem_kernel = fusion.fused_gpt_merge, cem_cuda.fused_cem
    tt_kernel = fusion.fused_token_transformer

    def record(name, shape, outs, refs, tol):
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(outs, refs))
        top = max(float(r.float().abs().max()) for r in refs)
        checks.append({"kernel": name, "shape": list(shape),
                       "max_abs_err": err, "max_abs_ref": top, "tol": tol,
                       "ok": err <= tol * top})

    def cpu(x):
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        return x.cpu() if torch.is_tensor(x) else x

    def spread(on_cpu, plain, out, n):
        """The plain version's own spread: on the CPU (sums in another
        order) against the card, on the call's first ``n`` images, beside
        the kernel's error on the same images (absolute where the plain
        output is all zeros: dp_path's pad shard)."""
        top = checks[-1]["max_abs_ref"] or 1.0
        checks[-1]["plain_spread"] = max(
            float((c.float() - p[:n].float().cpu()).abs().max())
            for c, p in zip(on_cpu, plain)) / top
        checks[-1]["err_same_images"] = max(
            float((o[:n].float() - p[:n].float()).abs().max())
            for o, p in zip(out, plain)) / top

    def merge(rgb, ir, stacked, *args, **kw):
        out = merge_kernel(rgb, ir, stacked, *args, **kw)
        plain = fusion_cuda.fused_gpt_merge_reference(
            rgb, ir, unprepared(stacked), *args, **kw)
        record("fused_gpt_merge", rgb.shape, out, plain, K4_EVAL_TOL)
        n = min(SPREAD_IMAGES, rgb.shape[0])
        spread(fusion_cuda.fused_gpt_merge_reference(
            rgb[:n].cpu(), ir[:n].cpu(), cpu(unprepared(stacked)),
            *(cpu(a) for a in args), **kw), plain, out, n)
        return out

    # K3's wrapper counts its launches on the name it is bound to, which
    # this replaces while it runs: wraps() gives the stand-in that count
    @functools.wraps(cem_kernel)
    def cem(x, *params, pack=None):
        out = cem_kernel(x, *params, pack=pack)
        record("fused_cem", x.shape, (out,),
               (cem_cuda.fused_cem_reference(x, *params),),
               K3_TOL[str(x.dtype).split(".")[-1]])
        return out

    def tt(x, stacked, num_heads=8):
        out = tt_kernel(x, stacked, num_heads)
        plain = transformer_cuda.fused_token_transformer_reference(
            x, unprepared(stacked), num_heads)
        record("fused_token_transformer", x.shape, (out,), (plain,),
               K1_EVAL_TOL)
        n = min(SPREAD_IMAGES, x.shape[0])
        spread((transformer_cuda.fused_token_transformer_reference(
            x[:n].cpu(), cpu(unprepared(stacked)), num_heads),), (plain,),
            (out,), n)
        return out

    def nms(boxes, scores, iou_thres, max_det):
        stats = torch.zeros(boxes.shape[0], nms_cuda.STATS_COLUMNS,
                            dtype=torch.int32, device=boxes.device)
        idx, valid = nms_cuda.nms_greedy(boxes, scores, iou_thres, max_det,
                                         stats=stats)
        r_idx, r_valid = nms_cuda.nms_greedy_reference(boxes, scores,
                                                       iou_thres, max_det)
        same = bool(torch.equal(idx, r_idx) and torch.equal(valid, r_valid))
        checks.append({"kernel": "nms_greedy", "shape": list(boxes.shape[:2]),
                       "identical": same, "ok": same})
        paths.extend(stats[:, 4].tolist())
        return idx, valid
    with mock.patch.object(fusion, "fused_gpt_merge", merge), \
            mock.patch.object(cem_cuda, "fused_cem", cem), \
            mock.patch.object(fusion, "fused_token_transformer", tt), \
            mock.patch.object(nms_mod, "nms_greedy", nms):
        yield


def check_summary(checks: list) -> dict:
    """Per kernel: calls, the shapes met, the largest error as a share of
    max |plain| (K3, K4) or whether every call was identical (K2)."""
    out = {}
    for name in sorted({c["kernel"] for c in checks}):
        cs = [c for c in checks if c["kernel"] == name]
        rec = {"calls": len(cs), "ok": all(c["ok"] for c in cs),
               "shapes": [list(x) for x in
                          sorted({tuple(c["shape"]) for c in cs})]}
        if "tol" in cs[0]:
            rec["max_err_over_max_ref"] = max(
                c["max_abs_err"] / (c["max_abs_ref"] or 1.0) for c in cs)
            rec["tol"] = cs[0]["tol"]
        for key in ("plain_spread", "err_same_images"):
            if key in cs[0]:
                rec[key] = max(c[key] for c in cs)
        out[name] = rec
    return out


def pseudo_labelled(torch, model, batches, dev, top: int):
    """The batches with each image's labels replaced by ``model``'s own
    ``top`` best detections (the evaluator's NMS; padded-frame normalized
    xywh), to be matched in the letterboxed frame as they are: ``shapes``
    is the identity, so that boxes reaching past the image, which random
    weights make many of, are not clipped onto one another (two labels
    clipped to the same box let only one detection match)."""
    import numpy as np

    from mmidet_tpu_torch.eval.evaluator import infer_batch
    out = []
    for b in batches:
        rgb = torch.from_numpy(b["rgb"]).to(dev).float() / 255.0
        ir = torch.from_numpy(b["ir"]).to(dev).float() / 255.0
        with torch.inference_mode():
            dets, valid = infer_batch(model, rgb, ir, 0.001, 0.6)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        ih, iw = rgb.shape[1:3]
        targets = np.zeros((len(dets), top, 5), np.float32)
        mask = np.zeros((len(dets), top), bool)
        for i in range(len(dets)):
            d = dets[i][valid[i]][:top]  # in the kernel's (score) order
            n = len(d)
            targets[i, :n] = np.stack([
                d[:, 5], (d[:, 0] + d[:, 2]) / 2 / iw,
                (d[:, 1] + d[:, 3]) / 2 / ih, (d[:, 2] - d[:, 0]) / iw,
                (d[:, 3] - d[:, 1]) / ih], 1)
            mask[i, :n] = True
        unclipped = [((1e9, 1e9), (1.0, (0.0, 0.0)))] * len(dets)
        out.append({**b, "targets": targets, "mask": mask,
                    "shapes": unclipped})
    return out


def phase_eval_path(torch, dev, card: str, data_seconds: float):
    """The evaluation path (``cli/val.py`` -> loaders -> the flagship ->
    the evaluator's NMS -> matching and AP) on the card; see the module
    docstring, step 11."""
    import itertools
    import shutil

    from mmidet_tpu_torch.cli import val as val_cli
    from mmidet_tpu_torch.data import native
    from mmidet_tpu_torch.data.datasets import PairedDataset
    from mmidet_tpu_torch.data.loader import PairedLoader, RectLoader
    from mmidet_tpu_torch.eval.evaluator import evaluate

    t_phase = time.perf_counter()
    sets = {k: PairedDataset(str(EVAL_DATA / k / "val_rgb" / "images"),
                             str(EVAL_DATA / k / "val_ir" / "images"), nc=2)
            for k in ("square", "rect")}
    names = ["box", "blob"]
    model, spec = val_cli.load_model_and_vars("yolov5l_fuse3_fourier", "", 2,
                                              device=dev)
    flags = val_cli.kernel_routes(spec, use_cem=True)
    if flags != {"kernel_cem": True, "kernel_merge": True,
                 "kernel_fusion": False} or \
            next(model.parameters()).dtype != torch.bfloat16:
        raise AssertionError(f"the val CLI's flagship is not the deploy "
                             f"form: {flags}")

    def run(name, loader, leg, forwards_per_batch=1, **kw):
        # untimed: every kernel call against its plain version at the
        # path's shapes, and K2's path per image (this pass also warms up)
        checks, paths = [], []
        with checked_kernels(torch, checks, paths):
            evaluate(model, loader(), nc=2, conf_thres=0.001, iou_thres=0.6,
                     names=names, device=dev, **kw)
        checked = check_summary(checks)
        # timed, as a user runs it: launches counted from 0
        shapes = []

        def batches():
            for b in loader():
                shapes.append(tuple(b["rgb"].shape))
                yield b
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = evaluate(model, batches(), nc=2, conf_thres=0.001,
                       iou_thres=0.6, names=names, device=dev, **kw)
        secs = time.perf_counter() - t0
        nb = len(shapes)
        n_img = sum(s[0] for s in shapes)
        fw = nb * forwards_per_batch
        launches = read_counts(fused_cem=fw, fused_gpt_merge=4 * fw,
                               nms_greedy=nb, nms_greedy_large=nb)
        calls = {k: v["calls"] for k, v in checked.items()}
        if not all(v["ok"] for v in checked.values()) or calls != {
                "fused_cem": fw, "fused_gpt_merge": 4 * fw,
                "nms_greedy": nb} or len(paths) != n_img:
            raise AssertionError(f"eval_path {name}: a kernel disagrees "
                                 f"with its plain version or was not "
                                 f"checked on every call: {checked}")
        return {"run": name, "batches": nb, "images": n_img,
                "batch_shapes": [list(x[1:3]) for x in sorted(set(shapes))],
                "loader_native": bool(leg), "launches": launches,
                "k2_paths": {p: paths.count(p) for p in sorted(set(paths))},
                "checked": checked,
                "speed_ms": res.speed_ms[0], "seconds": secs,
                "img_per_s": n_img / secs,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "P": res.mp, "R": res.mr, "mAP50": res.map50,
                "mAP": res.map}

    def square_loader(img=640, ds=None, bs=32):
        return PairedLoader(ds or sets["square"], bs, img, drop_last=False,
                            scaleup=False)

    tta_batch = list(itertools.islice(square_loader(), 1))
    square_leg = square_loader().use_native
    runs = [run("square", square_loader, square_leg),
            run("rect", lambda: RectLoader(sets["rect"], 32, 640),
                RectLoader(sets["rect"], 32, 640).use_native),
            run("tta", lambda: tta_batch, square_leg, forwards_per_batch=3,
                augment=True)]
    for r in runs:
        emit({"phase": "eval_path", "model": "yolov5l_fuse3_fourier",
              "card": card, "dtype": "bfloat16", "flags": flags,
              "native_available": native.available(),
              "gxx": shutil.which("g++") is not None, **r})
    want_shapes = {"square": [[640, 640]], "rect": [[544, 672]],
                   "tta": [[640, 640]]}
    for r in runs:
        want_images = min(32, len(sets["square"])) if r["run"] == "tta" \
            else len(sets[r["run"]])
        if r["batch_shapes"] != want_shapes[r["run"]] or \
                r["images"] != want_images:
            raise AssertionError(f"eval_path {r['run']}: unexpected batches "
                                 f"{r}")
    del model, tta_batch
    torch.cuda.empty_cache()

    # f32: the kernels against their plain versions on the same batches
    f32, _ = val_cli.load_model_and_vars("yolov5l_fuse3_fourier", "", 2,
                                         dtype=torch.float32, device=dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eight = {k: PairedDataset(ds.rgb_files[:8], ds.ir_files[:8], nc=2,
                              cache_dir=str(EVAL_DATA / k))
             for k, ds in sets.items()}
    small = {"square": list(square_loader(320, eight["square"], 8)),
             "rect": list(RectLoader(eight["rect"], 8, 320))}
    b0 = small["square"][0]
    set_kernel_flags(f32, False, False, False)
    condition(torch, f32, *(torch.from_numpy(b0[k]).to(dev).float() / 255.0
                            for k in ("rgb", "ir")))
    gates = []
    kernel_route, modules_route = (False, True, True), (False, False, False)
    for name, batches in small.items():
        nb = len(batches)
        # launches of each route's evaluate: the plain route none at all
        # (so the plain versions did replace the kernels), the modules
        # route K2 alone
        want = {"kernel": {"fused_cem": nb, "fused_gpt_merge": 4 * nb,
                           "nms_greedy": nb, "nms_greedy_large": nb},
                "plain": {"fused_cem": 0},
                "modules": {"nms_greedy": nb, "nms_greedy_large": nb}}
        launches = {}

        def run_route(route, labelled=None, **kw):
            set_kernel_flags(f32, *(modules_route if route == "modules"
                                    else kernel_route))
            ctx = plain_versions(torch) if route == "plain" \
                else contextlib.nullcontext()
            with ctx:
                zero_counts()
                res = evaluate(f32, labelled or batches, nc=2, names=names,
                               device=dev, **kw)
                launches[route] = read_counts(**want[route])
                if labelled:
                    return res, None, None
                with torch.inference_mode():
                    pred = torch.cat([f32(*(
                        torch.from_numpy(b[k]).to(dev).float() / 255.0
                        for k in ("rgb", "ir")))["pred"] for b in batches])
                pseudo = None if route == "kernel" else \
                    pseudo_labelled(torch, f32, batches, dev,
                                    EVAL_PSEUDO_TOP)
            return res, pseudo, pred

        res, pseudo, preds = {}, {}, {}
        for route in ("kernel", "plain", "modules"):
            res[route], pseudo[route], preds[route] = run_route(route)
        # the kernel route's own 20 best per image against each other
        # route's 20 best (AP pools the images; random weights do not
        # calibrate scores across images, so a 21st detection of one image
        # could outrank the first of another)
        vs = {route: run_route("kernel", pseudo[route],
                               max_det=EVAL_PSEUDO_TOP)[0]
              for route in ("plain", "modules")}
        metrics = {route: [r.mp, r.mr, r.map50, r.map]
                   for route, r in res.items()}

        def diff(route):
            return max(abs(a - b) for a, b in zip(metrics["kernel"],
                                                  metrics[route]))

        def pred_diff(route):  # boxes over max |box|; confidences absolute
            k, p = preds["kernel"], preds[route]
            return [float((k[..., :4] - p[..., :4]).abs().max()
                          / p[..., :4].abs().max()),
                    float((k[..., 4:] - p[..., 4:]).abs().max())]
        rec = {"phase": "eval_path_vs_plain", "set": name,
               "dtype": "float32", "img": 320, "images": 8,
               "batch_shape": list(batches[0]["rgb"].shape[1:3]),
               "launches": launches,
               "P_R_mAP50_mAP": metrics, "max_abs_diff": diff("plain"),
               "tol": EVAL_METRIC_TOL,
               "pseudo_labels_per_image": EVAL_PSEUDO_TOP,
               "pseudo_mAP50": vs["plain"].map50,
               "pseudo_mAP": vs["plain"].map,
               "pseudo_min_mAP50": EVAL_PSEUDO_MAP50,
               "pred_box_rel_conf_abs": pred_diff("plain"),
               "pred_tol": EVAL_PRED_TOL,
               # not gated: the unfused modules in f32 (K4 rounds its
               # streams to bf16 by design, as the TPU kernel does)
               "modules_max_abs_diff": diff("modules"),
               "modules_pseudo_mAP50": vs["modules"].map50,
               "modules_pseudo_mAP": vs["modules"].map,
               "modules_pred_box_rel_conf_abs": pred_diff("modules")}
        emit(rec)
        gates.append(rec)
        if rec["max_abs_diff"] > EVAL_METRIC_TOL or \
                rec["pseudo_mAP50"] < EVAL_PSEUDO_MAP50 or \
                max(rec["pred_box_rel_conf_abs"]) > EVAL_PRED_TOL:
            raise AssertionError(f"eval_path: the kernel route disagrees "
                                 f"with the plain versions: {rec}")
    del f32
    torch.cuda.empty_cache()

    # the val CLI itself, where yaml imports (the card machine may lack it)
    try:
        import yaml  # noqa: F401
    except ImportError:
        cli = {"phase": "eval_path_cli", "ran": False,
               "reason": "yaml does not import"}
    else:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            val_cli.main(["--cfg", "yolov5l_fuse3_fourier", "--data",
                          str(EVAL_DATA / "square" / "synthetic.yaml"),
                          "--batch-size", "32", "--img-size", "640"],
                         device=dev)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        if set(line) != {"P", "R", "mAP50", "mAP75", "mAP", "speed_ms"} or \
                not all(math.isfinite(v) for v in line.values()):
            raise AssertionError(f"the val CLI's JSON line: {line}")
        cli = {"phase": "eval_path_cli", "ran": True,
               "seconds": time.perf_counter() - t0, "json": line}
    try:
        import matplotlib  # noqa: F401
        cli["matplotlib"] = True
    except ImportError:
        cli["matplotlib"] = False
    emit({**cli, "data_seconds": data_seconds,
          "phase_seconds": time.perf_counter() - t_phase})
    return runs, gates, cli


def train_path_config(workdir: Path, epochs: int = 2, **kw):
    """The train path's run: the flagship at full width and depth, 640 px,
    batch 8 (accumulate 8 to nbs 64), aux losses as the reference, CEM on,
    bf16 autocast, basic augmentation with the default hyps (``kw``
    ``mosaic_prob=1.0``: mosaic, the JAX package's default), on the eval
    path's 64 square pairs as train and val set."""
    from mmidet_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(**{
        "model": "yolov5l_fuse3_fourier",
        "data": str(EVAL_DATA / "square" / "synthetic.yaml"),
        "epochs": epochs, "batch_size": 8, "img_size": 640,
        "workdir": str(workdir), "mosaic_prob": 0.0,
        "aux_mode": "reference", "use_cem": True, "dtype": "bfloat16",
        "seed": 0, "exist_ok": True, **kw})


def wait_timed(cls, waits: list, legs: list):
    """``cls`` (a train loader) whose iterations add the seconds spent
    waiting for each batch to a new entry of ``waits`` and record its
    decode leg in ``legs``; an evaluation loader (``drop_last=False``)
    iterates as it is."""
    class Timed(cls):
        def __iter__(self):
            it = super().__iter__()
            if not getattr(self, "drop_last", True):
                yield from it
                return
            waits.append(0.0)
            legs.append("native" if getattr(self, "use_native", False)
                        else "pil")
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    waits[-1] += time.perf_counter() - t0
                    yield item
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
    return Timed


def checked_eval(torch, phase: str, real_eval, evals: list):
    """A stand-in for the trainer's ``evaluate``: the train steps since the
    last evaluation launched no kernel; each evaluation runs first untimed
    with every K1 and K2 call held against its plain version
    (``checked_kernels``: K1 within ``K1_EVAL_TOL``, K2 identical indices,
    4 K1 calls and 1 K2 call a batch), then timed with the launches
    counted from 0; one record an evaluation into ``evals``."""
    def counted_eval(model, loader, nc, **kw):
        # the train steps since the last evaluation launched no kernel
        during_steps = read_counts()
        if any(during_steps.values()):
            raise AssertionError(f"{phase}: the train steps launched "
                                 f"kernels: {during_steps}")
        batches = list(loader)
        nb = len(batches)
        # untimed: every K1 and K2 call against its plain version
        checks, paths = [], []
        with checked_kernels(torch, checks, paths):
            real_eval(model, batches, nc, **kw)
        checked = check_summary(checks)
        calls = {k: v["calls"] for k, v in checked.items()}
        if not all(v["ok"] for v in checked.values()) or calls != {
                "fused_token_transformer": 4 * nb, "nms_greedy": nb}:
            raise AssertionError(f"{phase} eval: a kernel disagrees with "
                                 f"its plain version or was not checked on "
                                 f"every call: {checked}")
        # timed, as the trainer runs it: launches counted from 0
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = real_eval(model, batches, nc, **kw)
        secs = time.perf_counter() - t0
        launches = read_counts(fused_token_transformer=4 * nb,
                               nms_greedy=nb, nms_greedy_large=nb)
        zero_counts()
        evals.append({"batches": nb, "launches": launches,
                      "checked": checked,
                      "k2_paths": {p: paths.count(p)
                                   for p in sorted(set(paths))},
                      "speed_ms": res.speed_ms[0], "seconds": secs,
                      "dtype": str(next(model.parameters()).dtype),
                      "P": res.mp, "R": res.mr, "mAP50": res.map50})
        return res
    return counted_eval


def phase_train_path(torch, dev, card: str, phase: str = "train_path",
                     epochs: int = 2, **kw):
    """``train`` on the card (see the module docstring, step 12), its
    steps timed, the loader's waits timed, its per-epoch evaluations
    checked and counted, and its best checkpoint through the val CLI.
    ``kw`` goes to ``train_path_config``."""
    from unittest import mock

    from mmidet_tpu_torch.cli import val as val_cli
    from mmidet_tpu_torch.train import trainer as trainer_mod
    from mmidet_tpu_torch.train.checkpoint import checkpoints
    from mmidet_tpu_torch.train.ema import ModelEMA
    from mmidet_tpu_torch.train.optimizer import GroupedOptimizer

    t_phase = time.perf_counter()
    workdir = EVAL_DATA / f"{phase}_run"
    cfg = train_path_config(workdir, epochs, **kw)
    step_ms, opt_ms, evals, initial = [], [], [], {}
    waits, legs = [], []
    real_make = trainer_mod.make_train_step
    real_opt, real_ema = GroupedOptimizer.step, ModelEMA.update
    real_eval = trainer_mod.evaluate

    def make_timed(*a, **kw):
        inner = real_make(*a, **kw)

        def step(state, batch):
            if not initial:  # the EMA's weights before the first step
                initial.update({k: v.detach().clone() for k, v in
                                state.ema.state_dict().items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return step

    def timed_opt(self, opt_step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_opt(self, opt_step)
        torch.cuda.synchronize()
        opt_ms.append([(time.perf_counter() - t0) * 1e3])

    def timed_ema(self, model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_ema(self, model)
        torch.cuda.synchronize()
        opt_ms[-1].append((time.perf_counter() - t0) * 1e3)

    counted_eval = checked_eval(torch, phase, real_eval, evals)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(trainer_mod, "make_train_step", make_timed), \
            mock.patch.object(trainer_mod, "evaluate", counted_eval), \
            mock.patch.object(GroupedOptimizer, "step", timed_opt), \
            mock.patch.object(ModelEMA, "update", timed_ema), \
            mock.patch.object(trainer_mod, "PairedLoader", wait_timed(
                trainer_mod.PairedLoader, waits, legs)), \
            mock.patch.object(trainer_mod, "MosaicLoader", wait_timed(
                trainer_mod.MosaicLoader, waits, legs)):
        out = trainer_mod.train(cfg, device=dev)
    train_seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = read_counts()
    if any(after.values()):
        raise AssertionError(f"{phase}: kernels launched after the last "
                             f"evaluation: {after}")
    state = out["state"]
    ema_sd = state.ema.state_dict()
    ema_moved = max(float((ema_sd[k].float() - v.float()).abs().max())
                    for k, v in initial.items() if v.is_floating_point())
    losses = [{k: e[k] for k in ("epoch", "box", "obj", "cls", "aux")}
              for e in out["epochs"]]
    finite = all(math.isfinite(e[k]) for e in losses
                 for k in ("box", "obj", "cls", "aux"))
    after_first = step_ms[1:]
    micro = statistics.median(after_first)
    # images over each epoch's loop (loader, augmentation, copies to the
    # card, steps; the step timer's synchronisations included), the first
    # epoch's with cuDNN's first calls; the steps' own rate beside it
    loop_img_per_s = [e["batches"] * cfg.batch_size / e["seconds"]
                      for e in out["epochs"]]
    best = checkpoints(str(workdir / "ckpt_best"))
    loop_seconds = [e["seconds"] for e in out["epochs"]]
    rec = {"phase": phase, "model": "yolov5l_fuse3_fourier",
           "card": card, "img": 640, "batch": 8, "dtype": "bfloat16",
           "aux_mode": "reference", "mosaic": cfg.mosaic_prob > 0,
           "loader_leg": legs, "epochs": len(out["epochs"]),
           "micro_steps": len(step_ms), "optimizer_steps": len(opt_ms),
           "accumulate": state.optimizer.accumulate,
           "micro_step_ms": micro, "micro_step_ms_first": step_ms[0],
           "micro_step_ms_all": step_ms,
           "train_img_per_s": loop_img_per_s[-1],
           "loop_img_per_s_by_epoch": loop_img_per_s,
           "step_img_per_s": cfg.batch_size * 1e3 / micro,
           # seconds the loop waited for the loader's next batch, and
           # their share of each epoch's loop
           "loader_wait_s_by_epoch": waits,
           "loader_wait_share_by_epoch": [w / s for w, s in
                                          zip(waits, loop_seconds)],
           "optimizer_step_ms": [sum(x) for x in opt_ms],
           "optimizer_ms_split": opt_ms, "peak_mem_gb": peak,
           "losses": losses, "ema_max_change": ema_moved,
           "ema_updates": state.ema.updates, "evals": evals,
           "train_seconds": train_seconds, "best": best[-1:]}
    emit(rec)
    if not finite or ema_moved <= 0 or len(evals) != cfg.epochs or \
            len(opt_ms) != len(step_ms) // state.optimizer.accumulate or \
            not best or len(waits) != cfg.epochs:
        raise AssertionError(f"{phase}: losses finite {finite}, EMA "
                             f"moved {ema_moved}, {len(evals)} evaluations, "
                             f"{len(opt_ms)} optimizer steps, best {best}")

    # the run's best checkpoint through the val CLI
    buf = io.StringIO()
    t0 = time.perf_counter()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        val_cli.main(["--cfg", "yolov5l_fuse3_fourier", "--data",
                      cfg.data, "--weights", best[-1], "--batch-size", "32",
                      "--img-size", "640"], device=dev)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    cli = {"phase": f"{phase}_val_cli", "weights": best[-1],
           "seconds": time.perf_counter() - t0, "json": line,
           "launches": read_counts(),
           "phase_seconds": time.perf_counter() - t_phase}
    emit(cli)
    if set(line) != {"P", "R", "mAP50", "mAP75", "mAP", "speed_ms"} or \
            not all(math.isfinite(v) for v in line.values()):
        raise AssertionError(f"{phase}: the val CLI on the best "
                             f"checkpoint: {line}")
    rec["val_cli"] = cli
    return rec


# f32 train steps, card against CPU: the same weights and batch, autocast
# and TF32 off, dropout p = 0, 2 optimizer steps at lr 1e-3 (the weights'
# warmup lr 0, then lr0; the biases at 1e-3 both times).  Sums run in
# another order on the card (cuDNN's algorithms, the reductions), and
# BatchNorm on batch 2 normalises P5's 4x4 maps over 32 values: its
# backward subtracts means of large terms, so some P5 gradients carry a
# few % of rounding.  At the default lr (0.01, biases warming up from 0.1)
# the seeded model's dynamics also amplify the rounding: the second
# step's losses sat 7.2e-5 (this gate's model and batch) and 2.6e-4 (the
# card test's) apart.  Gates, with an H100's readings at lr 1e-3 (PR 12):
# each loss term within TRAIN_F32_LOSS_TOL of its size (read 6.8e-6 on
# step 1, 3.3e-5 on step 2: 3x); per tensor (parameters, BN buffers, EMA
# entries that changed by more than 1e-6) the card's change within
# TRAIN_F32_TOL of the CPU's largest change of that tensor (read 0.089 at
# worst, a P5 conv's weight, BN buffers 2.7e-4: 3.4x).  Both sides run the
# port's code, so this gate finds only where the card's run leaves the
# CPU's; the update itself is held against the JAX package on the CPU
# (tests/test_torch_port_train.py, test_torch_port_resume.py)
TRAIN_F32_LOSS_TOL = 1e-4
TRAIN_F32_TOL = 0.3


def train_steps_f32(torch, model, batch, steps: int):
    """``steps`` micro-steps of the port's train step in f32 (accumulate 1,
    the schedule's first steps at lr0 1e-3: lr 0 then lr0 for the
    weights)."""
    from mmidet_tpu_torch.losses.detection import LossHyp
    from mmidet_tpu_torch.train.optimizer import build_optimizer
    from mmidet_tpu_torch.train.schedule import ScheduleConfig
    from mmidet_tpu_torch.train.step import init_state, make_train_step
    from mmidet_tpu_torch.train.trainer import anchors_grid
    sched = ScheduleConfig(epochs=2, steps_per_epoch=2, warmup_epochs=0.0,
                           warmup_floor=1, lr0=1e-3, warmup_bias_lr=1e-3)
    opt, _ = build_optimizer(model, sched, 0.0005, total_batch_size=2,
                             nbs=2)
    state = init_state(model, opt)
    step = make_train_step(anchors_grid(model.spec), LossHyp(),
                           dtype="float32")
    dev = next(model.parameters()).device
    metrics = [step(state, {k: v.to(dev) for k, v in batch.items()})
               for _ in range(steps)]
    return state, [{k: float(v) for k, v in m.items()} for m in metrics]


def phase_train_f32_gate(torch, dev, card: str,
                         model_name: str = "yolov5l_fuse3_fourier",
                         phase: str = "train_f32_gate"):
    """Two f32 train steps of ``model_name`` (the flagship) at 128 px,
    batch 2, on the card and on the CPU from the same weights and
    batch."""
    import copy

    import numpy as np

    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.models.zoo import get_model_spec
    t0 = time.perf_counter()
    torch.manual_seed(0)
    cpu = TwoStreamDetector(get_model_spec(model_name, nc=2),
                            aux_mode="reference")
    for m in cpu.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    card_model = copy.deepcopy(cpu).to(dev)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    rng = np.random.default_rng(0)
    targets = np.zeros((2, 4, 5), np.float32)
    targets[:, :3] = [[1, 0.5, 0.5, 0.3, 0.4], [0, 0.25, 0.3, 0.1, 0.15],
                      [1, 0.7, 0.6, 0.2, 0.1]]
    batch = {"rgb": torch.from_numpy(
                 rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)),
             "ir": torch.from_numpy(
                 rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)),
             "targets": torch.from_numpy(targets),
             "mask": torch.from_numpy(np.arange(4)[None].repeat(2, 0) < 3)}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        s_card, m_card = train_steps_f32(torch, card_model, batch, 2)
        s_cpu, m_cpu = train_steps_f32(torch, cpu, batch, 2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    loss_err = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                    for k in ("box", "obj", "cls", "aux", "total"))
                for a, b in zip(m_card, m_cpu)]

    def shares(got: dict, want: dict, base: dict):
        """Per tensor max |card change - CPU change| / max |CPU change|,
        over tensors whose CPU change exceeds 1e-6."""
        out = {}
        for k, w in want.items():
            if not w.is_floating_point():
                continue
            dw = w.detach().float() - base[k].float()
            top = float(dw.abs().max())
            if top > 1e-6:
                dg = got[k].detach().float().cpu() - base[k].float()
                out[k] = float((dg - dw).abs().max()) / top
        return out
    groups = {
        "params": shares(dict(s_card.model.named_parameters()),
                         dict(s_cpu.model.named_parameters()), before),
        "bn_buffers": shares(
            {k: v for k, v in s_card.model.state_dict().items()
             if "running" in k},
            {k: v for k, v in s_cpu.model.state_dict().items()
             if "running" in k}, before),
        "ema": shares(s_card.ema.state_dict(), s_cpu.ema.state_dict(),
                      before)}
    worst = {g: (max(v.values()) if v else 0.0, len(v))
             for g, v in groups.items()}
    worst_key = {g: max(v, key=v.get) if v else None
                 for g, v in groups.items()}
    rec = {"phase": phase, "model": model_name, "card": card, "img": 128,
           "batch": 2,
           "steps": 2, "losses_card": m_card, "losses_cpu": m_cpu,
           "loss_max_rel_err_by_step": loss_err,
           "loss_tol": TRAIN_F32_LOSS_TOL,
           "max_share_and_tensors": worst, "worst_tensor": worst_key,
           "tol": TRAIN_F32_TOL, "seconds": time.perf_counter() - t0}
    emit(rec)
    if max(loss_err) > TRAIN_F32_LOSS_TOL or \
            any(w > TRAIN_F32_TOL for w, _ in worst.values()) or \
            not all(n for _, n in worst.values()):
        raise AssertionError(f"{phase}: the card's train steps "
                             f"disagree with the CPU's: {rec}")
    return rec


# ------------------------------------------------------------ phases 13-15
SERVE_BATCH = 16                # BatchingService's max_batch on the card
SERVE_PAIRS = 16                # distinct JPEG pairs the requests carry
# concurrency 16 against concurrency 1: the same fixed-shape program, a
# pair at another row of the batch; boxes in px, confidences relative
SERVE_BOX_TOL = 1.0
SERVE_CONF_RTOL = 1e-3
SERVE_DATA = ROOT / "runs" / "chip_smoke_serve"  # git-ignored; removed after
# the services' and the hub's confidence threshold here: at the default
# 0.25 the conditioned seeded flagship keeps too few boxes for the record
# comparisons to mean anything
SERVE_CONF = 0.01
# serve_path's timed loops: the serve CLI's default threshold, so that the
# responses' JSON work on the host is what a default server does
SERVE_TIMED_CONF = 0.25
HUB_IMAGES = 4                  # hub_path: images of 640x512
# hub_path, the kernel route's records against the plain versions' on the
# card: K1 sits at its plain version's own CPU-card spread (1.3% of max
# |plain|), which moves boxes by a few px and scores by a few percent, so
# records near the threshold or in an NMS tie come and go (on an H100:
# 87% matched); a fault in a kernel matches next to none
HUB_MATCH_MIN = 0.75


def serve_pairs():
    """``serve_bench``'s JPEG pair content at 640, rolled sideways per
    pair: 16 distinct pairs, and each as a JSON payload."""
    from mmidet_tpu_torch.tools import serve_bench as sb
    pairs = [sb._jpeg_pair(640, shift=37 * k) for k in range(SERVE_PAIRS)]
    return pairs, [sb.json_payload(*p) for p in pairs]


def letterboxed(torch, pairs, dev):
    """The pairs decoded and letterboxed as the service does: (rgb, ir),
    one batch each, [0, 1] floats on ``dev``."""
    import numpy as np

    from mmidet_tpu_torch.deploy.serve import _preprocess
    return [torch.from_numpy(np.stack([_preprocess(p[k], 640)[0]
                                       for p in pairs])).to(dev).float()
            / 255.0 for k in (0, 1)]


def record_gap(want: list, got: list) -> dict:
    """Each request's records against another run's: the same count and
    classes; the largest box (px) and relative confidence differences."""
    box = conf = 0.0
    same = len(want) == len(got)
    for a, b in zip(want, got):
        if [r["class"] for r in a] != [r["class"] for r in b]:
            same = False
            continue
        for r, s in zip(a, b):
            box = max(box, *(abs(r[k] - s[k]) for k in ("xmin", "ymin",
                                                         "xmax", "ymax")))
            conf = max(conf, abs(r["confidence"] - s["confidence"])
                       / r["confidence"])
    return {"same_counts_and_classes": same, "max_box_diff_px": box,
            "max_conf_rel_diff": conf, "records": [len(a) for a in want]}


def matched_share(want: list, got: list) -> float:
    """The share of ``got``'s records (over all requests) that have a
    record of the same class in ``want``'s at IoU >= 0.5."""
    def iou(a, b):
        w = min(a["xmax"], b["xmax"]) - max(a["xmin"], b["xmin"])
        h = min(a["ymax"], b["ymax"]) - max(a["ymin"], b["ymin"])
        inter = max(w, 0.0) * max(h, 0.0)
        area = [(r["xmax"] - r["xmin"]) * (r["ymax"] - r["ymin"])
                for r in (a, b)]
        return inter / max(area[0] + area[1] - inter, 1e-9)
    hits = [any(r["class"] == s["class"] and iou(r, s) >= 0.5 for s in w)
            for w, g in zip(want, got) for r in g]
    return sum(hits) / max(len(hits), 1)


def merge_levels(model) -> int:
    """The fusion levels a forward of ``model`` runs as K4 (4 in the
    flagship)."""
    return sum(bool(getattr(m, "merge_kernel", False))
               for m in model.modules())


def checked_requests(torch, svc, url, payloads, concurrency: int):
    """The requests at ``concurrency`` (each answered 200, or this
    raises) with every K3, K4 and K2 call in the dispatcher held against
    its plain version (``checked_kernels``, the eval path's tolerances),
    K3 and K2 once and K4 at each fusion level for every batch; returns
    the records by request and the checks' summary."""
    from mmidet_tpu_torch.tools import serve_bench as sb
    checks, paths, answers = [], [], {}
    svc.batch_log.clear()
    with checked_kernels(torch, checks, paths):
        sb._closed_loop(url, payloads, concurrency, len(payloads), answers)
    nb = len(svc.batch_log)
    checked = check_summary(checks)
    calls = {k: v["calls"] for k, v in checked.items()}
    if not all(v["ok"] for v in checked.values()) or calls != {
            "fused_cem": nb, "fused_gpt_merge": merge_levels(svc.model) * nb,
            "nms_greedy": nb}:
        raise AssertionError(f"a kernel in the dispatcher disagrees with "
                             f"its plain version or was not checked on "
                             f"every batch ({nb}): {checked}")
    return [answers[k] for k in range(len(payloads))], \
        {"batches": nb, **checked}


def phase_serve_path(torch, dev, card: str):
    """The serving front end as a user runs it: the flagship from
    ``cli.val.load_model_and_vars`` (BN folded, bf16, K3 + K4 + K2),
    conditioned, in a ``BatchingService`` (max_batch 16, 3 ms) behind a
    ``ThreadingHTTPServer``; 16 distinct JPEG pairs at 640.  Untimed: the
    16 at concurrency 16 with every kernel call checked, then each pair
    alone; the records must agree.  Timed through ``serve_bench``'s closed
    loop, on a second service at the serve CLI's default threshold:
    concurrency 1 (32 requests) and 32 (256), launches counted from 0.
    Returns the model, the pairs and the record."""
    from mmidet_tpu_torch.cli import val as val_cli
    from mmidet_tpu_torch.deploy.serve import BatchingService
    from mmidet_tpu_torch.tools import serve_bench as sb

    t_phase = time.perf_counter()
    model, _ = val_cli.load_model_and_vars("yolov5l_fuse3_fourier", "", 6,
                                           device=dev)
    pairs, payloads = serve_pairs()
    condition(torch, model, *letterboxed(torch, pairs[:4], dev))
    svc = BatchingService(model, [str(i) for i in range(6)], img_size=640,
                          conf_thres=SERVE_CONF, max_batch=SERVE_BATCH,
                          max_wait_ms=3.0, device=dev)
    with sb.serving(svc) as url:
        by_c16, checked = checked_requests(torch, svc, url, payloads, 16)
        by_c1 = [sb._post(url, p)[1] for p in payloads]
    gap = record_gap(by_c1, by_c16)
    # timed, as a user sees it: launches counted from 0
    svc = BatchingService(model, [str(i) for i in range(6)], img_size=640,
                          conf_thres=SERVE_TIMED_CONF,
                          max_batch=SERVE_BATCH, max_wait_ms=3.0, device=dev)
    with sb.serving(svc) as url:
        for p in payloads[:4]:  # warm the HTTP + decode + dispatch path
            sb._post(url, p)
        svc.batch_log.clear()
        torch.cuda.synchronize()
        zero_counts()
        answers1 = {}
        lat1, wall1 = sb._closed_loop(url, payloads, 1, 32, answers1)
        log1 = list(svc.batch_log)
        svc.batch_log.clear()
        lat32, wall32 = sb._closed_loop(url, payloads, 32, 256)
        log32 = list(svc.batch_log)
        torch.cuda.synchronize()
        fw = len(log1) + len(log32)
        launches = read_counts(fused_cem=fw,
                               fused_gpt_merge=merge_levels(model) * fw,
                               nms_greedy=fw)
    rec = {"phase": "serve_path", "model": "yolov5l_fuse3_fourier",
           "card": card, "dtype": "bfloat16", "img": 640,
           "conf_thres": SERVE_CONF, "timed_conf_thres": SERVE_TIMED_CONF,
           "max_batch": SERVE_BATCH, "max_wait_ms": 3.0,
           "payload_kib": len(payloads[0]) / 1024, "checked": checked,
           "c16_vs_c1": gap, "launches": launches, "forwards": fw,
           "c1": {"requests": len(lat1), "p50_ms": sb.pct(lat1, 50),
                  "p99_ms": sb.pct(lat1, 99), "req_per_s": len(lat1) / wall1,
                  "records_per_response": statistics.mean(
                      len(r) for r in answers1.values()),
                  **sb.batching_stats(log1, wall1)},
           "c32": {"requests": len(lat32), "req_per_s": len(lat32) / wall32,
                   "p50_ms": sb.pct(lat32, 50), "p99_ms": sb.pct(lat32, 99),
                   **sb.batching_stats(log32, wall32)},
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not gap["same_counts_and_classes"] or not sum(gap["records"]) or \
            gap["max_box_diff_px"] > SERVE_BOX_TOL or \
            gap["max_conf_rel_diff"] > SERVE_CONF_RTOL or \
            len(lat1) != 32 or len(lat32) != 256:
        raise AssertionError(f"serve_path: {rec}")
    return model, pairs, payloads, rec


def phase_int8_path(torch, dev, card: str, model, pairs, payloads):
    """The s8-storage deploy of the serve path's flagship: ``serve
    --int8``'s startup calibration (``_calibrate_int8``) on 4 of the pairs
    written under the git-ignored ``runs/`` (removed after); at batch 16,
    every K3, K4 and K2 call held against its plain version and the
    launches counted; the predictions against the float deploy's (printed,
    not gated); 16 requests through a ``BatchingService`` on it; the
    quantized forward timed against the float one, in turns."""
    import shutil

    from mmidet_tpu_torch.deploy.serve import BatchingService, _calibrate_int8
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    from mmidet_tpu_torch.tools import serve_bench as sb

    t_phase = time.perf_counter()
    for k, sub in enumerate(("rgb", "ir")):
        (SERVE_DATA / sub).mkdir(parents=True, exist_ok=True)
        for i, p in enumerate(pairs[:4]):
            (SERVE_DATA / sub / f"{i}.jpg").write_bytes(p[k])
    try:
        q_model = _calibrate_int8(model, str(SERVE_DATA / "rgb"),
                                  str(SERVE_DATA / "ir"), 640)
    finally:
        shutil.rmtree(SERVE_DATA, ignore_errors=True)
    n_scales = sum(k.endswith("out_scale") for k in q_model.state_dict())
    rgb, ir = letterboxed(torch, pairs, dev)
    with torch.inference_mode():
        checks, paths = [], []
        with checked_kernels(torch, checks, paths):
            non_max_suppression(q_model(rgb, ir)["pred"].float(),
                                conf_thres=SERVE_CONF)
        checked = check_summary(checks)
        torch.cuda.synchronize()
        zero_counts()
        q_pred = q_model(rgb, ir)["pred"].float()
        dets, valid = non_max_suppression(q_pred, conf_thres=SERVE_CONF)
        torch.cuda.synchronize()
        levels = merge_levels(q_model)
        launches = read_counts(fused_cem=1, fused_gpt_merge=levels,
                               nms_greedy=1)
        f_pred = model(rgb, ir)["pred"].float()
        rel = (q_pred - f_pred).abs() / f_pred.abs().clamp(min=1.0)
        times = {"float": [], "int8": []}
        for which in ("float", "int8", "int8", "float"):
            m = model if which == "float" else q_model
            times[which].append(time_ms(lambda: m(rgb, ir), reps=10,
                                        warmup=2))
    # serving: 16 requests through a BatchingService on the quantized model
    svc = BatchingService(q_model, [str(i) for i in range(6)], img_size=640,
                          conf_thres=SERVE_CONF, max_batch=SERVE_BATCH,
                          max_wait_ms=3.0, device=dev)
    with sb.serving(svc) as url:
        served, served_checked = checked_requests(torch, svc, url,
                                                  payloads, 16)
    q_ms, f_ms = (statistics.mean(times[k]) for k in ("int8", "float"))
    rec = {"phase": "int8_path", "model": "yolov5l_fuse3_fourier",
           "card": card, "dtype": "bfloat16", "batch": rgb.shape[0],
           "img": 640, "scales": n_scales, "checked": checked,
           "launches": launches,
           "kept_per_image": float(valid.sum(1).float().mean()),
           "vs_float_max_rel": float(rel.max()),
           "vs_float_mean_rel": float(rel.mean()),
           "forward_ms_int8": q_ms, "forward_ms_float": f_ms,
           "forward_ms_turns": times, "int8_over_float": q_ms / f_ms,
           "served": {"requests": len(served),
                      "records": [len(r) for r in served],
                      "checked": served_checked},
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not all(v["ok"] for v in checked.values()) or \
            {k: v["calls"] for k, v in checked.items()} != {
                "fused_cem": 1, "fused_gpt_merge": levels,
                "nms_greedy": 1} or \
            not bool(torch.isfinite(dets).all()) or len(served) != 16:
        raise AssertionError(f"int8_path: {rec}")
    del q_model
    torch.cuda.empty_cache()
    return rec


def hub_records(torch, m, imgs, ir, plain: bool):
    """``m(imgs, ir)``'s records, through the kernels or, with ``plain``,
    through their plain versions on the card."""
    ctx = plain_versions(torch) if plain else contextlib.nullcontext()
    with ctx:
        return m(imgs, ir).pandas()


def phase_hub_path(torch, dev, card: str):
    """``hub.yolov5s_gpt4`` as a user calls it (the deploy form on the
    card: K1 at its four levels, K3, K2), conditioned, on 4 images of
    640x512, plainly and with ``augment``: launches counted, every K1 and
    K2 call checked, and the records against the same model's plain
    versions on the card; then a bundle round trip: ``export_deploy_bundle``
    of that model, ``hub.custom`` and ``attempt_load_ensemble`` of two
    bundles, each answering."""
    import shutil

    import numpy as np
    from PIL import Image

    from mmidet_tpu_torch import hub
    from mmidet_tpu_torch.deploy.export import export_deploy_bundle
    from mmidet_tpu_torch.models.ensemble import attempt_load_ensemble
    from mmidet_tpu_torch.ops.nms import non_max_suppression

    t_phase = time.perf_counter()
    m = hub.yolov5s_gpt4(nc=6, conf=SERVE_CONF, device=dev)
    # serve_bench's content (the serve path's pairs), cropped to 640x512
    pairs, _ = serve_pairs()
    imgs, ir = ([np.asarray(Image.open(io.BytesIO(p[k])))[:512]
                 for p in pairs[:HUB_IMAGES]] for k in (0, 1))
    x, x_ir = (torch.from_numpy(np.stack([
        np.pad(a, ((64, 64), (0, 0), (0, 0)), constant_values=114)
        for a in arrs])).to(dev).float() / 255 for arrs in (imgs, ir))
    condition(torch, m.model, x, x_ir)
    runs = {}
    for augment in (False, True):
        m.augment = augment
        fw = 3 if augment else 1
        with torch.inference_mode():
            checks, paths = [], []
            with checked_kernels(torch, checks, paths):
                m(imgs, ir)
            checked = check_summary(checks)
            torch.cuda.synchronize()
            zero_counts()
            got = m(imgs, ir).pandas()
            torch.cuda.synchronize()
            launches = read_counts(fused_token_transformer=4 * fw,
                                   fused_cem=fw, nms_greedy=1)
            plain = hub_records(torch, m, imgs, ir, plain=True)
        gap = {**record_gap(plain, got),
               "matched_share": matched_share(plain, got)}
        runs["augment" if augment else "plain"] = {
            "launches": launches, "checked": checked, "vs_plain": gap}
        if {k: v["calls"] for k, v in checked.items()} != {
                "fused_cem": fw, "fused_token_transformer": 4 * fw,
                "nms_greedy": 1} or \
                not all(v["ok"] for v in checked.values()) or \
                gap["matched_share"] < HUB_MATCH_MIN:
            raise AssertionError(f"hub_path: {runs}")
    m.augment = False
    # a bundle round trip on the card
    bundle = SERVE_DATA / "bundle"
    try:
        export_deploy_bundle(str(bundle), m.model, m.model.spec,
                             names=m.names, img_size=640)
        custom = hub.custom(str(bundle), conf=SERVE_CONF, device=dev)
        zero_counts()
        custom_recs = custom(imgs, ir).pandas()
        ens = attempt_load_ensemble([str(bundle), str(bundle)], device=dev)
        with torch.inference_mode():
            pred = ens(x, x_ir)["pred"]
            e_dets, e_valid = non_max_suppression(pred.float(),
                                                  conf_thres=SERVE_CONF)
        torch.cuda.synchronize()
        bundle_launches = read_counts(fused_token_transformer=12,
                                      fused_cem=3, nms_greedy=2)
    finally:
        shutil.rmtree(SERVE_DATA, ignore_errors=True)
    rec = {"phase": "hub_path", "model": "yolov5s_gpt4", "card": card,
           "images": [HUB_IMAGES, 512, 640], "runs": runs,
           "custom_vs_hub": record_gap(hub_records(torch, m, imgs, ir,
                                                   plain=False),
                                       custom_recs),
           "ensemble_boxes": list(pred.shape),
           "ensemble_kept": int(e_valid.sum()),
           "bundle_launches": bundle_launches,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not rec["custom_vs_hub"]["same_counts_and_classes"] or \
            not sum(runs["plain"]["vs_plain"]["records"]) or \
            rec["custom_vs_hub"]["max_box_diff_px"] > 0 or \
            pred.shape[1] != 2 * 3 * (80 ** 2 + 40 ** 2 + 20 ** 2) or \
            not rec["ensemble_kept"] or \
            not bool(torch.isfinite(e_dets).all()):
        raise AssertionError(f"hub_path: {rec}")
    del m, custom, ens
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------- phases 27-28
# s8_gate_path: the JAX package's chip settings of tools/s8_gate.py (s
# scale, 160 px, 8 pairs, batch 8, f32).  S8_EPOCHS: on an H100 the float
# deploy's gate-protocol mAP50 read 0.000 at 250 epochs, 0.273 at 600 and
# 0.728 at 1000 (about 0.1 s an epoch, one step each), and 0.8078 at 1000
# on every run once the tool trained on deterministic cuDNN, so 1000 is
# the depth that clears S8_FLOAT_MIN with room (the JAX record took 1500)
S8_EPOCHS = 1000
S8_IMG = 160
S8_FLOAT_MIN = 0.5              # converged: two zero mAP50s cannot pass
# the regression band: int8 - float mAP50.  The JAX package's converged
# TPU record is -0.0544 (s scale, 160 px, 1500 epochs); twice that catches
# an int8 deploy that lost its scales or clips (a x0.5 clip read -0.49 on
# the TPU) without failing a correct port on rounding jitter
S8_DELTA_MIN = -0.10
S8_TOOL_GATE = 0.02             # the tool's own |delta| verdict (printed)
S8_DATA = ROOT / "runs" / "chip_smoke_s8"  # git-ignored; removed after


def phase_s8_gate_path(torch, dev, card: str):
    """The s8-storage deploy's accuracy gate as ``tools/s8_gate.py`` runs
    it: ``train_arm`` trains yolov5s_add to convergence on the synthetic
    set (augmentation, mosaic and aux losses off, f32), then
    ``gate_record`` evaluates the EMA weights through the float deploy and
    through ``make_quant_deploy`` (calibrated on the gate loader's first
    batch) under the gate protocol; every K2 call of both evaluations held
    against its plain version (``checked_kernels``) and counted, the
    trainer's final evaluation counted.  Asserts convergence (float mAP50
    >= ``S8_FLOAT_MIN``), an ``out_scale`` on every fused conv of the int8
    model, int8 mAP50 > 0 and delta >= ``S8_DELTA_MIN``."""
    import shutil
    from unittest import mock

    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.nn import quant as quant_mod
    from mmidet_tpu_torch.nn.layers import ConvBnAct
    from mmidet_tpu_torch.ops import nms_cuda
    from mmidet_tpu_torch.tools import s8_gate

    t_phase = time.perf_counter()
    shutil.rmtree(S8_DATA, ignore_errors=True)
    # the tool as a user runs it: a fresh process's TF32 defaults (cuDNN
    # on, matmul off), which earlier phases leave cuDNN's switched off.
    # The gate's result depends on them: trained with cuDNN's TF32 off, the
    # deterministic run's weights read mAP50 0.755 through PairedLoader at
    # 160 and 0.0 through the gate's RectLoader (192 x 192 batches, the
    # images shifted 16 px), a model fitted to 8 unaugmented pairs at
    # fixed positions; with the defaults, 0.8078 on every run
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        zero_counts()
        res = s8_gate.train_arm(S8_EPOCHS, S8_IMG, "s", 8, 8, "float32",
                                str(S8_DATA), 50, device=dev)
        torch.cuda.synchronize()
        # the train steps launch no kernel; the final epoch's evaluation
        # (one val batch) launches K2 once
        train_launches = read_counts(nms_greedy=1)
        t_train = time.perf_counter() - t_phase
        quantized = []

        def capture(*a, **k):
            quantized.append(real_quant(*a, **k))
            return quantized[-1]
        real_quant = quant_mod.make_quant_deploy
        checks, paths = [], []
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(quant_mod, "make_quant_deploy", capture), \
                checked_kernels(torch, checks, paths):
            rec = s8_gate.gate_record(
                TwoStreamDetector(res["spec"], aux_mode="off"),
                res["deploy"], res["data"], S8_IMG, 8, S8_TOOL_GATE,
                device=dev, epochs=S8_EPOCHS, name="yolov5s_add")
        torch.cuda.synchronize()
        t_gate = time.perf_counter() - t0
        checked = check_summary(checks)
        # RectLoader's 192 x 192 batches give pools of 4536 boxes: K2's
        # large form, which counts among K2's launches and apart
        pools = [c["shape"][1] for c in checks if c["kernel"] == "nms_greedy"]
        n_k2 = len(pools)
        launches = read_counts(nms_greedy=n_k2, nms_greedy_large=sum(
            k > nms_cuda.SMALL_POOL for k in pools))
        convs = [m for m in quantized[0].modules()
                 if isinstance(m, ConvBnAct)]
        scaled = sum(m.quant and m.bn is None and "out_scale" in m._buffers
                     for m in convs)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(S8_DATA, ignore_errors=True)
    out = {"phase": "s8_gate_path", "card": card, "model": "yolov5s_add",
           "img": S8_IMG, "pairs": 8, "batch": 8, "dtype": "float32",
           "epochs": S8_EPOCHS, "float_map50": rec["float_map50"],
           "int8_map50": rec["int8_map50"], "delta": rec["delta"],
           "delta_min": S8_DELTA_MIN, "float_min": S8_FLOAT_MIN,
           "tool_gate": S8_TOOL_GATE, "tool_pass": rec["pass"],
           "record": rec, "internal_map50": res["last_results"].map50,
           "fused_convs": len(convs), "out_scales": scaled,
           "checked": checked, "launches": launches,
           "train_launches": train_launches,
           "epoch_seconds_median": statistics.median(
               e["seconds"] for e in res["epochs"]),
           "train_seconds": t_train, "gate_seconds": t_gate,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(out)
    # two evaluations of one batch each, every K2 call checked
    if rec["float_map50"] < S8_FLOAT_MIN or rec["int8_map50"] <= 0.0 or \
            rec["delta"] < S8_DELTA_MIN or not convs or \
            scaled != len(convs) or n_k2 != 2 or \
            not all(v["ok"] for v in checked.values()):
        raise AssertionError(f"s8_gate_path: {out}")
    return out


RESUME_DATA = ROOT / "runs" / "chip_smoke_resume"  # git-ignored; removed after


def phase_resume_path(torch, dev, card: str):
    """The spot-VM restart loop: ``train`` writes a run of yolov5s_add at
    64 px on 8 synthetic pairs (batch 8, accumulate 1), stopped after the
    first of two epochs (trained with ``epochs=1``, then ``epochs: 2`` in
    its ``opt.yaml``), beside a JAX-package run (an orbax step folder);
    ``tools.resume_all`` finds the port's run, names and skips the JAX
    one, and resumes the run on the card from ``ckpt/epoch0.pt``'s state
    (epoch counter and optimizer step) to the final epoch; a second
    ``resume_all`` finds nothing.  Each run's evaluation launches K2 once
    (counted)."""
    import os
    import shutil
    from unittest import mock

    import yaml

    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.tools import resume_all
    from mmidet_tpu_torch.train import trainer as trainer_mod
    from mmidet_tpu_torch.train.checkpoint import checkpoints

    t_phase = time.perf_counter()
    shutil.rmtree(RESUME_DATA, ignore_errors=True)
    runs = RESUME_DATA / "runs"
    run, jax_run = runs / "exp", runs / "jax_exp"
    try:
        yaml_path = make_synthetic_pair_dataset(str(RESUME_DATA / "data"),
                                                n=8, img=64)
        cfg = trainer_mod.TrainConfig(
            model="yolov5s_add", data=yaml_path, epochs=1, batch_size=8,
            img_size=64, workdir=str(run), mosaic_prob=0.0, nbs=8,
            autoanchor=False, exist_ok=True, seed=0, warmup_floor=1)
        zero_counts()
        t0 = time.perf_counter()
        trainer_mod.train(cfg, device=dev)
        first_launches = read_counts(nms_greedy=1)
        t_first = time.perf_counter() - t0
        opt_path = run / "opt.yaml"
        opt = yaml.safe_load(opt_path.read_text())
        opt_path.write_text(yaml.safe_dump({**opt, "epochs": 2}))
        (jax_run / "ckpt" / "0").mkdir(parents=True)
        (jax_run / "opt.yaml").write_text(yaml.safe_dump(
            {"epochs": 4, "model": "yolov5s_add"}))
        stopped = [os.path.basename(p) for p in
                   checkpoints(str(run / "ckpt"))]
        first = torch.load(run / "ckpt" / "epoch0.pt", map_location="cpu",
                           weights_only=True)
        restored = []
        real_restore = trainer_mod.restore_checkpoint

        def restore(src, state):
            out = real_restore(src, state)
            restored.append({"src": src, "step": out[1], **out[2],
                             "micro_step": out[0].micro_step})
            return out
        said = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(trainer_mod, "restore_checkpoint", restore), \
                contextlib.redirect_stdout(said):
            results = resume_all.main([str(runs)], device=dev)
        resume_launches = read_counts(nms_greedy=1)
        t_resume = time.perf_counter() - t0
        final = [os.path.basename(p) for p in checkpoints(str(run / "ckpt"))]
        last = torch.load(run / "ckpt" / "epoch1.pt", map_location="cpu",
                          weights_only=True)
        again = io.StringIO()
        with contextlib.redirect_stdout(again):
            second = resume_all.main([str(runs)], device=dev)
    finally:
        shutil.rmtree(RESUME_DATA, ignore_errors=True)
    rec = {"phase": "resume_path", "card": card, "model": "yolov5s_add",
           "img": 64, "batch": 8, "stopped_at": stopped, "restored": restored,
           "first": {k: int(first[k]) for k in ("epoch", "step",
                                                 "micro_step")},
           "last": {k: int(last[k]) for k in ("epoch", "step", "micro_step")},
           "epochs_run": [e["epoch"] for r in results for e in r["epochs"]],
           "final_ckpts": final, "said": said.getvalue().splitlines(),
           "second": again.getvalue().splitlines(),
           "launches_first": first_launches, "launches": resume_launches,
           "first_seconds": t_first, "resume_seconds": t_resume,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if stopped != ["epoch0.pt"] or len(results) != 1 or \
            rec["epochs_run"] != [1] or final[-1] != "epoch1.pt" or \
            [(r["src"], r["epoch"], r["step"], r["micro_step"])
             for r in restored] != [(str(run / "ckpt"), 0, 1, 1)] or \
            rec["first"] != {"epoch": 0, "step": 1, "micro_step": 1} or \
            rec["last"] != {"epoch": 1, "step": 2, "micro_step": 2} or \
            f"skipping {jax_run}:" not in said.getvalue() or \
            "1 interrupted run(s) found" not in said.getvalue() or \
            second != [] or \
            "0 interrupted run(s) found" not in again.getvalue():
        raise AssertionError(f"resume_path: {rec}")
    return rec


# ------------------------------------------------------------ phases 16-18
# ------------------------------------------------------------ export_path
EXPORT_DATA = ROOT / "runs" / "chip_smoke_export"  # git-ignored; removed after
# the JAX package's ONNX gate: max |onnx - port| / max(1, |port|), boxes in
# pixels and scores in [0, 1] (tests/test_onnx_export.py)
ONNX_TOL = 2e-3
ONNX_IMG = 128
# a stand-in for the reference checkout's ``models/yolo.py``: its ``Model``
# holds a state dict by the reference's names, as the pickled
# ``models.yolo.Model`` of a reference checkpoint does
STUB_YOLO = """
import torch
from torch import nn


class Model(nn.Module):
    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if name not in mod._modules:
                    mod.add_module(name, nn.Module())
                mod = mod._modules[name]
            if value.is_floating_point() and "running" not in leaf:
                mod.register_parameter(leaf, nn.Parameter(value.clone()))
            else:
                mod.register_buffer(leaf, value.clone())
"""


def reference_checkpoint(torch, spec):
    """A reference-format checkpoint of ``spec`` under ``EXPORT_DATA``:
    a stub checkout (``reference/models/yolo.py``, put on ``sys.path`` as
    a user's checkout is) and ``best.pt``, pickled ``models.yolo.Model``
    objects in fp16, ``model`` and an ``ema`` that differs from it by
    noise.  Returns
    (path, the EMA's state dict in f32 as the file holds it)."""
    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    repo = EXPORT_DATA / "reference"
    (repo / "models").mkdir(parents=True, exist_ok=True)
    (repo / "models" / "__init__.py").write_text("")
    (repo / "models" / "yolo.py").write_text(STUB_YOLO)
    sys.path.insert(0, str(repo))
    from models.yolo import Model
    torch.manual_seed(0)
    sd = TwoStreamDetector(spec).state_dict()
    gen = torch.Generator().manual_seed(1)
    ema = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
           if v.is_floating_point() else v for k, v in sd.items()}
    path = EXPORT_DATA / "best.pt"
    torch.save({"epoch": -1, "model": Model(sd).half(),
                "ema": Model(ema).half(), "updates": 7}, path)
    ema = {k: v.half().float() if v.is_floating_point() else v
           for k, v in ema.items()}
    return str(path), ema


@contextlib.contextmanager
def warnings_logged():
    """The warnings logged inside the block, as a list of messages."""
    import logging
    got: list = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())
    handler = Keep(logging.WARNING)
    logging.getLogger().addHandler(handler)
    try:
        yield got
    finally:
        logging.getLogger().removeHandler(handler)


def graph_ops(prog) -> dict:
    """The custom-op nodes of a loaded program, counted by name."""
    out: dict = {}
    for n in prog.graph.nodes:
        t = str(n.target)
        if t.startswith("mmidet."):
            name = t.split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def exported_run(torch, model, name: str, want: dict, reps: int = 5):
    """``export_program`` of a deploy model at batch 16, 640, saved to a
    ``.pt2`` file, loaded back and run: its graph's custom ops and its
    launches against ``want``, its ``pred`` against the eager module's,
    NMS through K2, and the two forwards timed in turns."""
    from mmidet_tpu_torch.deploy.export import export_program, load_program
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    B, S = 16, 640
    dev = next(model.parameters()).device
    t0 = time.perf_counter()
    blob = export_program(model, S, B)
    t_export = time.perf_counter() - t0
    f = EXPORT_DATA / f"{name}.pt2"
    f.write_bytes(blob)
    t0 = time.perf_counter()
    prog = load_program(f.read_bytes())
    t_load = time.perf_counter() - t0
    nodes = graph_ops(prog)
    gen = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(B, S, S, 3, generator=gen, device=dev)
    ir = torch.rand(B, S, S, 3, generator=gen, device=dev)
    with torch.inference_mode():
        eager = model(rgb, ir)["pred"]
        prog(rgb, ir)  # first call
        torch.cuda.synchronize()
        zero_counts()
        got = prog(rgb, ir)
        torch.cuda.synchronize()
        launches = read_counts(**want)
        zero_counts()
        dets, valid = non_max_suppression(got.float(), conf_thres=0.001,
                                          iou_thres=0.45)
        torch.cuda.synchronize()
        nms_launches = read_counts(nms_greedy=1)
        err = float((got.float() - eager.float()).abs().max())
        spread = None
        if not torch.equal(got, eager):
            # the same kernels and ATen ops on the same inputs: a
            # difference can only be an algorithm cuDNN picks per call
            torch.backends.cudnn.deterministic = True
            try:
                spread = float((model(rgb, ir)["pred"].float()
                                - eager.float()).abs().max())
            finally:
                torch.backends.cudnn.deterministic = False
        turns = {"eager": [], "exported": []}
        for which in ("eager", "exported", "exported", "eager"):
            fn = (lambda: model(rgb, ir)["pred"]) if which == "eager" \
                else (lambda: prog(rgb, ir))
            turns[which].append(time_ms(fn, reps=reps, warmup=1))
    rec = {"model": name, "batch": B, "img": S,
           "dtype": str(next(model.parameters()).dtype).split(".")[1],
           "export_s": t_export, "load_s": t_load, "pt2_mb": len(blob) / 1e6,
           "graph_ops": nodes, "launches": launches,
           "nms_launches": nms_launches, "identical": bool(
               torch.equal(got, eager)), "max_abs_err": err,
           "eager_spread": spread,
           "kept_per_image": float(valid.sum(1).float().mean()),
           "order": "eager, exported, exported, eager",
           "eager_ms_turns": turns["eager"],
           "exported_ms_turns": turns["exported"],
           "eager_ms": statistics.mean(turns["eager"]),
           "exported_ms": statistics.mean(turns["exported"])}
    if nodes != want or tuple(got.shape) != tuple(eager.shape) or \
            not bool(torch.isfinite(dets).all()) or \
            not (rec["identical"] or (spread is not None and err <= spread)):
        raise AssertionError(f"export_path {name}: {rec}")
    del prog
    return rec


def op_dispatch(torch, dev):
    """One K3 call (the flagship's, (16, 640, 640, 3) bf16) and one K4 call
    (its P5 level, (16, 20, 20, 1024), L = 8) through the custom op against
    the direct ctypes call of the op's CUDA implementation, timed in turns
    (op, direct, direct, op), each ms a CUDA-event median around the call:
    the dispatcher's cost per call."""
    from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda
    from mmidet_tpu_torch.nn import transformer_cuda as tc
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(16, 640, 640, 3, generator=gen).to(dev, torch.bfloat16)
    w = [(0.2 * torch.randn(s, generator=gen)).to(dev) for s in (
        (3, 3, 3, 24), (24,), (24,), (24,), (3, 3, 24, 3), (3,))]
    pack = cem_cuda.pack_cem_weights(*w, torch.bfloat16)
    st = random_stack(1024, 8, gen, dev)
    ws = tc.prepare_stack(st, dev)
    stack = [ws[k] for k in tc.STACK_KEYS]
    s = (torch.randn(16, 20, 20, 1024, generator=gen) * 0.5).to(
        dev, torch.bfloat16)
    pos = (0.2 * torch.randn(1, 128, 1024, generator=gen)).to(dev)
    ln = (torch.ones(1024, device=dev), torch.zeros(1024, device=dev))
    calls = {"fused_cem": (cem_cuda.cem_op, cem_cuda._fused_cem_cuda,
                           (x, *w, pack)),
             "fused_gpt_merge": (fusion_cuda.gpt_merge_op,
                                 fusion_cuda._gpt_merge_cuda,
                                 (s, s, stack, pos, *ln, 8, None, None))}
    out = {}
    with torch.inference_mode():
        for name, (op, direct, args) in calls.items():
            a, b = op(*args), direct(*args)
            same = all(torch.equal(u, v) for u, v in zip(
                *((t,) if torch.is_tensor(t) else t for t in (a, b))))
            turns = {"op": [], "direct": []}
            for which in ("op", "direct", "direct", "op"):
                fn = op if which == "op" else direct
                turns[which].append(time_ms(lambda: fn(*args), reps=20))
            out[name] = {"identical": same, "op_ms_turns": turns["op"],
                         "direct_ms_turns": turns["direct"],
                         "op_ms": statistics.mean(turns["op"]),
                         "direct_ms": statistics.mean(turns["direct"])}
            if not same:
                raise AssertionError(f"op_dispatch {name}: the op and the "
                                     "direct call disagree")
    return out


def phase_export_path(torch, dev, card: str):
    """The deploy user's path from the weights they hold to an artifact
    they ship: (a) a reference-format checkpoint of the flagship (pickled
    stub modules, fp16, ``model`` + ``ema``) through
    ``cli.val.load_model_and_vars``: the EMA taken, no tensor left at its
    init;
    (b) ``export_program`` of that deploy model (BN folded, bf16, K3 + K4,
    batch 16 at 640) to a ``.pt2`` and back: K3 once and K4 four times in
    the graph and in the launch counts, ``pred`` against the eager
    module's, NMS through K2, both timed in turns; the op's dispatch cost
    against the direct call for one K3 and one K4 call; (c) the same for
    yolov5s_gpt4 (K1 four times); (e) ``deploy.export.main --onnx
    --savedmodel --tflite`` on the checkpoint, the TF legs' seconds apart;
    (d) its ``model.onnx``, the flagship in f32 at 640, decoded back (node
    and initializer counts), and ``export_onnx`` at 128 run through the
    numpy runner against the port's plain f32 forward on the card; (f) its
    ``savedmodel/`` and ``model.tflite`` decoded back by the port's codecs
    (nodes, the op histograms, every TFLite operator a builtin, MB), and
    ``export_savedmodel`` + ``export_tflite`` at 128 run through ``tf_np``
    against the card's f32 forward through K3 and K4 (launches asserted)
    and against its plain route."""
    import shutil

    import numpy as np

    from mmidet_tpu_torch.cli import val
    from mmidet_tpu_torch.deploy import (export, onnx_np, onnx_proto, tf_np,
                                         tf_proto, tflite_fb)
    from mmidet_tpu_torch.deploy.onnx_export import export_onnx
    from mmidet_tpu_torch.models.zoo import get_model_spec
    from mmidet_tpu_torch.nn.fuse import fold_batchnorm

    t_phase = time.perf_counter()
    flagship = "yolov5l_fuse3_fourier"
    spec = get_model_spec(flagship)
    shutil.rmtree(EXPORT_DATA, ignore_errors=True)
    EXPORT_DATA.mkdir(parents=True)
    rec = {"phase": "export_path", "card": card, "seconds": {}}
    secs = rec["seconds"]
    try:
        # (a) the reference checkpoint through the val CLI's loader: no
        # tensor of the model left at its init (``build_model`` warns of
        # any), and the tensors that BN folding leaves as they are (the
        # transformers', the Detect head's) are the EMA's in bf16
        t0 = time.perf_counter()
        path, ema = reference_checkpoint(torch, spec)
        with warnings_logged() as warned:
            model, _ = val.load_model_and_vars(flagship, path, spec.nc,
                                               device=dev)
        got = model.state_dict()
        unfolded = [k for k in got if "trans_blocks" in k or "pos_emb" in k
                    or f"model.{len(spec.layers) - 1}." in k]
        rec["checkpoint"] = {
            "warnings": warned, "compared": len(unfolded),
            "ema_taken": bool(unfolded) and all(torch.equal(
                got[k], ema[k].to(dev, torch.bfloat16)) for k in unfolded),
            "flags": val.kernel_routes(spec, True)}
        del got
        secs["checkpoint"] = time.perf_counter() - t0
        if warned or not rec["checkpoint"]["ema_taken"]:
            raise AssertionError(f"export_path checkpoint: {rec}")
        # (b) the flagship's deploy form, exported
        t0 = time.perf_counter()
        rec["flagship"] = exported_run(torch, model, flagship,
                                       {"fused_cem": 1, "fused_gpt_merge": 4})
        del model
        torch.cuda.empty_cache()
        secs["flagship"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["op_dispatch"] = op_dispatch(torch, dev)
        secs["op_dispatch"] = time.perf_counter() - t0
        # (c) yolov5s_gpt4 through K1
        t0 = time.perf_counter()
        gpt4 = build_model(torch, get_model_spec("yolov5s_gpt4"),
                           kernel_fusion=True).to(dev, torch.bfloat16)
        rec["gpt4"] = exported_run(torch, gpt4, "yolov5s_gpt4",
                                   {"fused_token_transformer": 4})
        del gpt4
        torch.cuda.empty_cache()
        secs["gpt4"] = time.perf_counter() - t0
        # (e) the export CLI on the checkpoint, with --onnx, --savedmodel
        # and --tflite: its bundle's model.onnx, savedmodel/ and
        # model.tflite are the flagship's graphs at 640 in f32; the TF
        # legs' entry points timed as the CLI calls them
        t0 = time.perf_counter()
        out = EXPORT_DATA / "bundle"
        tf_secs = {}

        def timed(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    tf_secs[key] = time.perf_counter() - t
            return run
        entry = export.export_savedmodel, export.export_tflite
        export.export_savedmodel = timed(entry[0], "export_savedmodel")
        export.export_tflite = timed(entry[1], "export_tflite")
        try:
            with contextlib.redirect_stdout(io.StringIO()) as said:
                export.main(["--cfg", flagship, "--weights", path, "--out",
                             str(out), "--onnx", "--savedmodel", "--tflite"],
                            device=dev)
        finally:
            export.export_savedmodel, export.export_tflite = entry
        files = sorted(p.name for p in out.iterdir())
        rec["cli"] = {"files": files,
                      "said": said.getvalue().strip().splitlines()}
        secs["cli"] = time.perf_counter() - t0
        if not {"model.json", "model.pt", "model.pt2", "model.onnx",
                "savedmodel", "savedmodel_graph",
                "model.tflite"} <= set(files):
            raise AssertionError(f"export_path cli: {rec}")
        # (f) the TF legs' files at 640 decoded back by the port's codecs
        t0 = time.perf_counter()
        body = tf_proto.load(str(out / "savedmodel")).serve_function()
        lite = tflite_fb.load(str(out / "model.tflite"))
        lite_ops = collections.Counter(
            tflite_fb.BUILTIN_NAMES.get(lite.opcodes[o.opcode],
                                        lite.opcodes[o.opcode])
            for o in lite.operators)
        rec["tf"] = {
            "img": 640, "export_s": tf_secs,
            "savedmodel_nodes": len(body.nodes),
            "savedmodel_ops": dict(collections.Counter(
                n.op for n in body.nodes).most_common()),
            "savedmodel_mb": (out / "savedmodel" / "saved_model.pb")
            .stat().st_size / 1e6,
            "tflite_operators": len(lite.operators),
            "tflite_tensors": len(lite.tensors),
            "tflite_ops": dict(lite_ops.most_common()),
            "tflite_mb": (out / "model.tflite").stat().st_size / 1e6,
            "all_builtin": all(isinstance(k, str) for k in lite_ops)}
        del body, lite
        secs["tf_decode"] = time.perf_counter() - t0
        if not rec["tf"]["all_builtin"]:
            raise AssertionError(f"export_path tf: {rec['tf']}")
        # (d) the ONNX leg on the checkpoint's weights, f32: the graph at
        # 640 decoded back, and at 128 run in numpy against the card
        t0 = time.perf_counter()
        g640 = onnx_proto.Model.load(str(out / "model.onnx"))
        onnx_mb = (out / "model.onnx").stat().st_size / 1e6
        shutil.rmtree(out)
        f32 = fold_batchnorm(val.build_model(spec, ema).eval())
        t1 = time.perf_counter()
        export_onnx(spec, f32, ONNX_IMG, str(EXPORT_DATA / "small.onnx"))
        t_emit = time.perf_counter() - t1
        small = onnx_proto.Model.load(str(EXPORT_DATA / "small.onnx"))
        t1 = time.perf_counter()
        sm_small = export.export_savedmodel(str(EXPORT_DATA / "small_sm"),
                                            f32, ONNX_IMG)
        lite_small = export.export_tflite(sm_small, str(EXPORT_DATA /
                                                        "small.tflite"))
        t_tf_emit = time.perf_counter() - t1
        gen = torch.Generator().manual_seed(12)
        rgb, ir = (torch.rand(1, ONNX_IMG, ONNX_IMG, 3, generator=gen)
                   for _ in range(2))
        t0 = time.perf_counter()
        got = onnx_np.run(small, {"rgb": rgb.permute(0, 3, 1, 2).numpy(),
                                  "ir": ir.permute(0, 3, 1, 2).numpy()})
        t_run = time.perf_counter() - t0
        feeds = {"rgb": rgb.numpy(), "ir": ir.numpy()}
        tf_runs, tf_run_s = {}, {}
        for key, load in (("savedmodel", lambda: tf_proto.load(sm_small)),
                          ("tflite", lambda: tflite_fb.load(lite_small))):
            t1 = time.perf_counter()
            tf_runs[key] = tf_np.run(load(), feeds)["output_0"]
            tf_run_s[key] = time.perf_counter() - t1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = f32.to(dev)
        with torch.inference_mode():
            ref = f32(rgb.to(dev), ir.to(dev))["pred"].cpu().numpy()
            # the same f32 forward through K3 and K4
            set_kernel_flags(f32, False, True, True)
            zero_counts()
            ref_k = f32(rgb.to(dev), ir.to(dev))["pred"].cpu().numpy()
            tf_launches = read_counts(fused_cem=1, fused_gpt_merge=4)
            set_kernel_flags(f32, False, False, False)

        def rel(a, b) -> float:
            return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
        err = rel(got["pred"], ref)
        rec["onnx"] = {
            "img": 640, "nodes": len(g640.graph.nodes),
            "initializers": len(g640.graph.initializers), "mb": onnx_mb,
            "run_img": ONNX_IMG, "emit_s": t_emit, "run_s": t_run,
            "max_rel_err": err, "tol": ONNX_TOL,
            "pred_shape": list(got["pred"].shape)}
        rec["tf"].update({
            "run_img": ONNX_IMG, "emit_s": t_tf_emit, "run_s": tf_run_s,
            "max_rel_err": {f"{k}_vs_{route}": rel(v, want)
                            for k, v in tf_runs.items()
                            for route, want in (("kernels", ref_k),
                                                ("plain", ref))},
            "kernels_vs_plain": rel(ref_k, ref), "launches": {
                k: v for k, v in tf_launches.items() if v},
            "tol": ONNX_TOL})
        del f32, g640
        secs["onnx"] = time.perf_counter() - t0
        if err >= ONNX_TOL or got["pred"].shape != ref.shape:
            raise AssertionError(f"export_path onnx: {rec}")
        if (max(rec["tf"]["max_rel_err"].values()) >= ONNX_TOL
                or any(v.shape != ref.shape for v in tf_runs.values())):
            raise AssertionError(f"export_path tf: {rec['tf']}")
    finally:
        sys.path[:] = [p for p in sys.path
                       if p != str(EXPORT_DATA / "reference")]
        shutil.rmtree(EXPORT_DATA, ignore_errors=True)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# A reference-format YAML with every row the JAX detector takes beyond the
# named grammars: a copy of the layout that tests/test_torch_port_zoo_layers
# .py:_yaml holds (tests/test_torch_port_export_rows.py checks that the
# two are the same)
ROWS_YAML = """
nc: 2
depth_multiple: 1.0
width_multiple: 0.25
anchors:
  - [10, 13, 16, 30, 33, 23]
  - [30, 61, 62, 45, 59, 119]
backbone:
  [[-1, 1, Conv, [32, 3, 2]],  # 0 /2
   [-1, 1, nn.ZeroPad2d, [[0, 1, 0, 1]]],  # 1
   [-1, 1, nn.MaxPool2d, [2, 1, 0]],  # 2
   [-1, 1, GhostBottleneck, [64, 3, 2]],  # 3 /4
   [-1, 2, Bottleneck, [64]],  # 4 repeated
   [-1, 1, BottleneckCSP, [64, 1]],  # 5
   [-1, 1, MixConv2d, [64, [1, 3]]],  # 6
   [-1, 1, CrossConv, [64, 3, 1]],  # 7
   [-1, 1, GhostConv, [64, 3, 1]],  # 8
   [-1, 1, Contract, [2]],  # 9 /8
   [-1, 1, Conv, [128, 1, 1]],  # 10
   [-1, 1, C3TR, [128]],  # 11
   [-1, 1, SPPF, [128, 5]],  # 12
   [-1, 1, DWConv, [128, 3, 2]],  # 13 /16
  ]
head:
  [[-1, 1, nn.Upsample, [null, 2, bilinear]],  # 14 /8
   [[-1, 12], 1, Concat, [1]],  # 15
   [-1, 1, Conv, [64, 1, 1]],  # 16
   [-1, 1, Expand, [2]],  # 17 /4
   [-1, 1, Conv, [64, 3, 2]],  # 18 /8
   [[18, 13], 1, Detect, [nc, anchors]],  # 19
  ]
"""
# export_rows_path: the models whose TF files hold the rows beyond the
# ONNX leg's (zoo names, ``YAML_MODELS`` keys, "rows" for ``ROWS_YAML``)
EXPORT_ROWS_MODELS = ("yolov5x_mamba", "yolov3-tiny", "yolov3",
                      "yolov5s-transformer", "rows")


def export_rows_spec(name: str):
    import yaml

    from mmidet_tpu_torch.models.spec import load_yolo_yaml
    from mmidet_tpu_torch.models.zoo import get_model_spec
    if name == "rows":
        return load_yolo_yaml(yaml.safe_load(ROWS_YAML))
    return yaml_spec(name) if name in YAML_MODELS else get_model_spec(name)


def phase_export_rows_path(torch, dev, card: str):
    """The SavedModel and TFLite legs of the rows beyond the ONNX leg's,
    for each of ``EXPORT_ROWS_MODELS`` (seeded, BN folded, f32): the
    mamba family's widest, yolov5x_mamba (MambaFusion at four levels),
    the three YAML models of ``yaml_path`` (nn.MaxPool2d, nn.ZeroPad2d,
    C3TR) and ``ROWS_YAML`` (every other row); (a) ``export_savedmodel``
    and ``export_tflite`` at 640, batch 1, timed, decoded back by the
    port's codecs (nodes, op histograms, every TFLite operator a builtin,
    MB), then removed; (b) both forms at 128 (``ONNX_IMG``) encoded and
    decoded in memory (the files' bytes, not written: a call's disk
    writes are capped) and run through ``deploy/tf_np.py`` against the
    card's f32 forward of the same weights (TF32 off) on its plain route
    and, where the model has the CEM, through K3 (launches asserted)."""
    import os
    import shutil

    import numpy as np

    from mmidet_tpu_torch.deploy import (export, tf_graph, tf_np, tf_proto,
                                         tflite_fb)
    from mmidet_tpu_torch.models.spec import is_two_stream

    def rel(a, b) -> float:
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

    t_phase = time.perf_counter()
    out_dir = EXPORT_DATA / "rows"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    recs, launches = [], {}
    try:
        for name in EXPORT_ROWS_MODELS:
            t0 = time.perf_counter()
            spec = export_rows_spec(name)
            two = is_two_stream(spec)
            model = build_model(torch, spec, use_cem=two)
            rec = {"phase": "export_rows_path", "model": name, "card": card,
                   "params_m": sum(p.numel() for p in model.parameters())
                   / 1e6, "rows": sorted({ld.name for ld in spec.layers}),
                   "img": 640, "seconds": {}}
            secs = rec["seconds"]
            secs["build"] = time.perf_counter() - t0
            # (a) the files at 640
            sm = str(out_dir / f"{name}_savedmodel")
            lite = str(out_dir / f"{name}.tflite")
            t1 = time.perf_counter()
            export.export_savedmodel(sm, model, 640, 1, two_stream=two)
            secs["export_savedmodel"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            export.export_tflite(sm, lite)
            secs["export_tflite"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            body = tf_proto.load(sm).serve_function()
            fb = tflite_fb.load(lite)
            ops = collections.Counter(
                tflite_fb.BUILTIN_NAMES.get(fb.opcodes[o.opcode],
                                            fb.opcodes[o.opcode])
                for o in fb.operators)
            rec.update(
                savedmodel_nodes=len(body.nodes),
                savedmodel_ops=dict(collections.Counter(
                    n.op for n in body.nodes).most_common()),
                savedmodel_mb=os.path.getsize(
                    os.path.join(sm, "saved_model.pb")) / 1e6,
                tflite_operators=len(fb.operators),
                tflite_ops=dict(ops.most_common()),
                tflite_mb=os.path.getsize(lite) / 1e6,
                all_builtin=all(isinstance(k, str) for k in ops))
            del body, fb
            shutil.rmtree(sm)
            os.remove(lite)
            secs["decode"] = time.perf_counter() - t1
            # (b) both forms at 128 in memory, through tf_np
            t1 = time.perf_counter()
            graph = tf_graph.emit_graph(spec, model, ONNX_IMG, 1)
            smf = tf_proto.decode_savedmodel(
                tf_proto.savedmodel_bytes(graph)[0])
            del graph
            fbf = tflite_fb.decode(tflite_fb.encode(tflite_fb.convert(smf)))
            secs["emit_128"] = time.perf_counter() - t1
            gen = torch.Generator().manual_seed(13)
            xs = [torch.rand(1, ONNX_IMG, ONNX_IMG, 3, generator=gen)
                  for _ in range(1 + two)]
            feeds = dict(zip(("rgb", "ir"), (x.numpy() for x in xs)))
            got, run_s = {}, {}
            for key, decoded in (("savedmodel", smf), ("tflite", fbf)):
                t1 = time.perf_counter()
                got[key] = tf_np.run(decoded, feeds)["output_0"]
                run_s[key] = time.perf_counter() - t1
            del smf, fbf
            model = model.to(dev)
            want = {}
            with torch.inference_mode():
                xd = [x.to(dev) for x in xs]
                want["plain"] = model(*xd)["pred"].cpu().numpy()
                if two:
                    set_kernel_flags(model, False, True, False)
                    zero_counts()
                    want["kernels"] = model(*xd)["pred"].cpu().numpy()
                    launches[name] = read_counts(fused_cem=1)["fused_cem"]
                    set_kernel_flags(model, False, False, False)
            rec.update(
                run_img=ONNX_IMG, run_s=run_s, tol=ONNX_TOL,
                pred_shape=list(want["plain"].shape),
                max_rel_err={f"{k}_vs_{route}": rel(v, w)
                             for k, v in got.items()
                             for route, w in want.items()},
                launches={"fused_cem": launches.get(name, 0)})
            if "kernels" in want:
                rec["kernels_vs_plain"] = rel(want["kernels"], want["plain"])
            del model
            torch.cuda.empty_cache()
            secs["total"] = time.perf_counter() - t0
            emit(rec)
            if (not rec["all_builtin"]
                    or any(v.shape != want["plain"].shape
                           for v in got.values())
                    or not all(math.isfinite(e) and e < ONNX_TOL
                               for e in rec["max_rel_err"].values())):
                raise AssertionError(f"export_rows_path {name}: {rec}")
            recs.append(rec)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out = {"phase": "export_rows_path_done", "card": card,
           "models": [r["model"] for r in recs], "launches": launches,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def mamba_levels(torch, model, rgb, ir, reps: int = 10):
    """Each MambaFusion level of ``model`` timed alone on the inputs the
    forward gives it (CUDA events), and the selective scan's share of it:
    ``linear_recurrence`` timed alone at that level's (B, 128, d_inner,
    d_state) f32 shape, times the 2 x n_layers calls a level makes."""
    from mmidet_tpu_torch.nn.mamba import MambaFusion, linear_recurrence
    inputs = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, i=i: inputs.__setitem__(i, inp))
        for i, m in enumerate(model.model) if isinstance(m, MambaFusion)]
    try:
        with torch.inference_mode():
            model(rgb, ir)
    finally:
        for h in hooks:
            h.remove()
    levels = []
    gen = torch.Generator(device=rgb.device).manual_seed(6)
    for i, (r, i_) in sorted(inputs.items()):
        mod = model.model[i]
        cfg = mod.fwd.cfg
        b, c, h, w = r.shape
        n_tok = 2 * mod.grid[0] * mod.grid[1]
        shape = (b, n_tok, cfg.d_inner, cfg.d_state)
        a = torch.rand(shape, generator=gen, device=rgb.device)
        x = torch.randn(shape, generator=gen, device=rgb.device)
        with torch.inference_mode():
            ms = time_ms(lambda: mod(r, i_), reps=reps, warmup=2)
            scan_ms = time_ms(lambda: linear_recurrence(a, x), reps=reps,
                              warmup=2)
        calls = 2 * cfg.n_layers
        levels.append({"layer": i, "d_model": c, "hw": [h, w],
                       "tokens": n_tok, "d_inner": cfg.d_inner,
                       "ms": ms, "scan_ms_per_call": scan_ms,
                       "scan_calls": calls,
                       "scan_share": calls * scan_ms / ms})
        del a, x
    total = sum(lv["ms"] for lv in levels)
    return {"mamba_levels": levels, "mamba_levels_ms": total,
            "scan_share_of_levels": sum(
                lv["scan_calls"] * lv["scan_ms_per_call"]
                for lv in levels) / total}


# Reference-format YAML text, laid out as Ultralytics YOLOv5 v5.0's
# models/hub/yolov3-tiny.yaml, yolov3.yaml and yolov5s-transformer.yaml
# (nc 80, their anchors); ``models.spec.load_yolo_yaml`` reads the rows
YAML_MODELS = {
    "yolov3-tiny": """
nc: 80
depth_multiple: 1.0
width_multiple: 1.0
anchors:
  - [10,14, 23,27, 37,58]  # P4/16
  - [81,82, 135,169, 344,319]  # P5/32
backbone:
  [[-1, 1, Conv, [16, 3, 1]],  # 0
   [-1, 1, nn.MaxPool2d, [2, 2, 0]],  # 1-P1/2
   [-1, 1, Conv, [32, 3, 1]],
   [-1, 1, nn.MaxPool2d, [2, 2, 0]],  # 3-P2/4
   [-1, 1, Conv, [64, 3, 1]],
   [-1, 1, nn.MaxPool2d, [2, 2, 0]],  # 5-P3/8
   [-1, 1, Conv, [128, 3, 1]],
   [-1, 1, nn.MaxPool2d, [2, 2, 0]],  # 7-P4/16
   [-1, 1, Conv, [256, 3, 1]],
   [-1, 1, nn.MaxPool2d, [2, 2, 0]],  # 9-P5/32
   [-1, 1, Conv, [512, 3, 1]],
   [-1, 1, nn.ZeroPad2d, [[0, 1, 0, 1]]],  # 11
   [-1, 1, nn.MaxPool2d, [2, 1, 0]],  # 12
  ]
head:
  [[-1, 1, Conv, [1024, 3, 1]],
   [-1, 1, Conv, [256, 1, 1]],
   [-1, 1, Conv, [512, 3, 1]],  # 15 (P5/32-large)
   [-2, 1, Conv, [128, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 8], 1, Concat, [1]],  # cat backbone P4
   [-1, 1, Conv, [256, 3, 1]],  # 19 (P4/16-medium)
   [[19, 15], 1, Detect, [nc, anchors]],  # Detect(P4, P5)
  ]
""",
    "yolov3": """
nc: 80
depth_multiple: 1.0
width_multiple: 1.0
anchors:
  - [10,13, 16,30, 33,23]  # P3/8
  - [30,61, 62,45, 59,119]  # P4/16
  - [116,90, 156,198, 373,326]  # P5/32
backbone:
  [[-1, 1, Conv, [32, 3, 1]],  # 0
   [-1, 1, Conv, [64, 3, 2]],  # 1-P1/2
   [-1, 1, Bottleneck, [64]],
   [-1, 1, Conv, [128, 3, 2]],  # 3-P2/4
   [-1, 2, Bottleneck, [128]],
   [-1, 1, Conv, [256, 3, 2]],  # 5-P3/8
   [-1, 8, Bottleneck, [256]],
   [-1, 1, Conv, [512, 3, 2]],  # 7-P4/16
   [-1, 8, Bottleneck, [512]],
   [-1, 1, Conv, [1024, 3, 2]],  # 9-P5/32
   [-1, 4, Bottleneck, [1024]],  # 10
  ]
head:
  [[-1, 1, Bottleneck, [1024, False]],
   [-1, 1, Conv, [512, [1, 1]]],
   [-1, 1, Conv, [1024, 3, 1]],
   [-1, 1, Conv, [512, 1, 1]],
   [-1, 1, Conv, [1024, 3, 1]],  # 15 (P5/32-large)
   [-2, 1, Conv, [256, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 8], 1, Concat, [1]],  # cat backbone P4
   [-1, 1, Bottleneck, [512, False]],
   [-1, 1, Bottleneck, [512, False]],
   [-1, 1, Conv, [256, 1, 1]],
   [-1, 1, Conv, [512, 3, 1]],  # 22 (P4/16-medium)
   [-2, 1, Conv, [128, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 6], 1, Concat, [1]],  # cat backbone P3
   [-1, 1, Bottleneck, [256, False]],
   [-1, 2, Bottleneck, [256, False]],
   [[27, 22, 15], 1, Detect, [nc, anchors]],  # Detect(P3, P4, P5)
  ]
""",
    "yolov5s-transformer": """
nc: 80
depth_multiple: 0.33
width_multiple: 0.50
anchors:
  - [10,13, 16,30, 33,23]  # P3/8
  - [30,61, 62,45, 59,119]  # P4/16
  - [116,90, 156,198, 373,326]  # P5/32
backbone:
  [[-1, 1, Focus, [64, 3]],  # 0-P1/2
   [-1, 1, Conv, [128, 3, 2]],  # 1-P2/4
   [-1, 3, C3, [128]],
   [-1, 1, Conv, [256, 3, 2]],  # 3-P3/8
   [-1, 9, C3, [256]],
   [-1, 1, Conv, [512, 3, 2]],  # 5-P4/16
   [-1, 9, C3, [512]],
   [-1, 1, Conv, [1024, 3, 2]],  # 7-P5/32
   [-1, 1, SPP, [1024, [5, 9, 13]]],
   [-1, 3, C3TR, [1024, False]],  # 9 <-- C3TR() transformer module
  ]
head:
  [[-1, 1, Conv, [512, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 6], 1, Concat, [1]],  # cat backbone P4
   [-1, 3, C3, [512, False]],  # 13
   [-1, 1, Conv, [256, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 4], 1, Concat, [1]],  # cat backbone P3
   [-1, 3, C3, [256, False]],  # 17 (P3/8-small)
   [-1, 1, Conv, [256, 3, 2]],
   [[-1, 14], 1, Concat, [1]],  # cat head P4
   [-1, 3, C3, [512, False]],  # 20 (P4/16-medium)
   [-1, 1, Conv, [512, 3, 2]],
   [[-1, 10], 1, Concat, [1]],  # cat head P5
   [-1, 3, C3, [1024, False]],  # 23 (P5/32-large)
   [[17, 20, 23], 1, Detect, [nc, anchors]],  # Detect(P3, P4, P5)
  ]
""",
}


def yaml_spec(name: str):
    import yaml

    from mmidet_tpu_torch.models.spec import load_yolo_yaml
    return load_yolo_yaml(yaml.safe_load(YAML_MODELS[name]))


# the YAML models' 80 classes put a seeded model's scores near the Detect
# prior (obj 0.02 x cls 0.0076, about 1.5e-4), below the path's 0.001: NMS
# there runs at 1e-5, so that K2's pools hold boxes
YAML_CONF = 1e-5


def phase_yaml_path(torch, dev, card: str, reps: int = 5):
    """The three YAML models (``YAML_MODELS``), single-stream: each seeded,
    BN folded and conditioned (``condition``, on the CPU at 320), bf16 on
    the card, batch 16 at 640, forward + NMS (``YAML_CONF``) with K2's one
    launch asserted (launches counted from 0), timed; then in f32 at 320,
    batch 2, card against CPU (TF32 off) within PATH_TOL, and NMS on the
    card's predictions through K2 against greedy's plain version."""
    import copy

    from mmidet_tpu_torch.ops.nms import non_max_suppression

    B, S, small_img = 16, 640, 320
    recs = []
    for name in YAML_MODELS:
        t0 = time.perf_counter()
        spec = yaml_spec(name)
        model = build_model(torch, spec, use_cem=False)
        small = torch.rand(2, small_img, small_img, 3,
                           generator=torch.Generator().manual_seed(8))
        condition(torch, model, small, None)
        n_params = sum(p.numel() for p in model.parameters())
        f32_model = copy.deepcopy(model)
        model = model.to(dev, torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(7)
        rgb = torch.rand(B, S, S, 3, generator=gen, device=dev)

        def nms(pred, conf=YAML_CONF):
            return non_max_suppression(pred.float(), conf_thres=conf,
                                       iou_thres=0.45)

        with torch.inference_mode():
            nms(model(rgb)["pred"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            pred = model(rgb)["pred"]
            dets, valid = nms(pred)
            torch.cuda.synchronize()
            launches = read_counts(nms_greedy=1)
            n_box = sum(3 * (S // st) ** 2 for st in spec.strides)
            if tuple(pred.shape) != (B, n_box, 5 + spec.nc) or \
                    not bool(torch.isfinite(pred).all()) or \
                    not bool(torch.isfinite(dets).all()):
                raise AssertionError(f"yaml_path: bad output of {name}: "
                                     f"{tuple(pred.shape)}")
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            fwd_ms = time_ms(lambda: model(rgb)["pred"], reps=reps, warmup=1)
            nms_ms = time_ms(lambda: nms(pred), reps=reps, warmup=1)
        del model, pred, dets
        # f32 at 320: card against CPU
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            cpu_pred = f32_model(small)["pred"]
            gpu_pred = f32_model.to(dev)(small.to(dev))["pred"]
            d_cpu, v_cpu = nms(gpu_pred.cpu())
            d_gpu, v_gpu = nms(gpu_pred)
        err = float((gpu_pred.cpu() - cpu_pred).abs().max())
        close = bool(torch.allclose(gpu_pred.cpu(), cpu_pred, rtol=PATH_TOL,
                                    atol=PATH_TOL))
        nms_same = bool(torch.equal(v_cpu, v_gpu.cpu())
                        and torch.allclose(d_cpu, d_gpu.cpu(), atol=1e-5,
                                           rtol=0))
        rec = {"phase": "yaml_path", "model": name, "card": card,
               "batch": B, "img": S, "dtype": "bfloat16", "conf": YAML_CONF,
               "params_m": n_params / 1e6, "strides": list(spec.strides),
               "rows": sorted({ld.name for ld in spec.layers}),
               "launches_per_forward": launches,
               "kept_per_image": float(valid.sum(1).float().mean()),
               "forward_ms_per_batch": fwd_ms, "nms_ms_per_batch": nms_ms,
               "forward_img_per_s": B / fwd_ms * 1e3,
               "forward_nms_img_per_s": B / (fwd_ms + nms_ms) * 1e3,
               "peak_mem_gb": peak_gb,
               "f32_vs_cpu": {"img": small_img, "batch": 2,
                              "pred_max_abs_err": err,
                              "pred_max_abs": float(cpu_pred.abs().max()),
                              "tol": PATH_TOL, "pred_close": close,
                              "nms_identical": nms_same,
                              "kept": int(v_gpu.sum())},
               "seconds": time.perf_counter() - t0}
        emit(rec)
        if not (close and nms_same and rec["kept_per_image"] > 0
                and int(v_gpu.sum()) > 0):
            raise AssertionError(f"yaml_path: {name} on the card disagrees "
                                 f"with the CPU or kept nothing")
        recs.append(rec)
        del f32_model, gpu_pred
        torch.cuda.empty_cache()
    return recs


def phase_p1(torch, dev):
    """P1's entry point as a user runs it (``python -m
    mmidet_tpu_torch.tools.probe_igemm``: batch 128 at 160x160, C = 64 and
    the C = 128 arm), launches counted from 0; then batch 16, the
    flagship's serving batch."""
    from mmidet_tpu_torch.tools import probe_igemm
    zero_counts()
    arms = probe_igemm.main(["128", "160", "64"], device=str(dev))
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["conv_chain"] < 1 or any(
            v for k, v in launches.items() if k != "conv_chain"):
        raise AssertionError(f"P1's entry point missed its kernel: {launches}")
    recs = arms + [probe_igemm.measure(16, 160, 64, dev)]
    report = recs[0]["ptxas"]
    if len(report) != 2 or any("spill_stores" not in r for r in report):
        raise AssertionError(f"no ptxas report of P1's two kernels (C = 64 "
                             f"and 128) for the library built: {report}")
    bad = [r for r in report
           if r["spill_stores"] or r["spill_loads"] or r["wgmma_serialized"]]
    if bad:
        raise AssertionError(f"P1's kernel spills registers or has its "
                             f"wgmma serialised: {bad}")
    for r in recs:
        emit({"phase": "p1_conv_chain", **r})
        torch.cuda.empty_cache()
    return recs, launches


def phase_p2_p3(torch, dev):
    """P2's and P3's entry points (``probe_cem_r3``, ``probe_cem_fb``), each
    body against its plain version with its times, the library call's and
    the launch floor's, launches counted from 0."""
    from mmidet_tpu_torch.tools import probe_cem_fb, probe_cem_r3
    zero_counts()
    r3 = probe_cem_r3.main(device=str(dev))
    fb = probe_cem_fb.main(device=str(dev))
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["halo_sum"] < 4 or launches["lane_matmul"] < 3 or any(
            v for k, v in launches.items()
            if k not in ("halo_sum", "lane_matmul")):
        raise AssertionError(f"P2/P3's entry points missed their kernels: "
                             f"{launches}")
    for r in r3 + fb:
        emit({"phase": "p2_p3_cem_probes", **r})
    return r3, fb, launches


# mosaic_gate: the mosaic augmentation on the card against the same
# function on the CPU, the same batch and draws.  The default hyp's path
# gathers two taps an axis and sums two products a row and a column (the
# same operations on both sides, f32, TF32 off), then the HSV maps: 1e-5
# of values in [0, 1].  The general path's warp builds and inverts each
# 3x3 matrix on each side (cos, sin, tan and the inverse may round apart
# by an ulp), and each sample point, a coordinate below 2s = 1280, lands
# on the f32 grid there (spacing 2^-23 * 1024 = 1.2e-4 px): one step in x
# and one in y move a bilinear value across a unit edge by up to 1.2e-4
# each, so its warped images (the canvas through ``warp_image``) within
# 2.5e-4 (read 1.5e-4 on an H100); then the HSV gains and the flips,
# applied on both sides to the CPU's warped images, within 1e-5.  End to
# end the general path is not gated per pixel: the multiplicative hue
# gain (h * g mod 1) jumps by up to hsv_h (0.015) at the hue circle's
# wrap, so a warp rounding that moves a pixel's hue across 0 moves it by
# about 0.01 (read 0.013 on an H100 at 95 of 19.7M values); the record
# shows that error.  Labels normalized, through the same matrices: 1e-4.
# Masks equal.
MOSAIC_IMG_TOL = 1e-5
MOSAIC_WARP_TOL = 2.5e-4
MOSAIC_LABEL_TOL = 1e-4


def general_warp_gate(torch, A, cpu, card_batch, draws, got, want):
    """The general path's stages, card against CPU (see MOSAIC_WARP_TOL):
    the warped images, and the gains and flips on the CPU's warped images.
    Returns (the second's max error, a record)."""
    s = cpu["rgb4"].shape[2]
    dev = card_batch["rgb4"].device
    warped = {}
    for side, b, dr in (("cpu", cpu, draws),
                        ("card", card_batch, _to(torch, draws, dev))):
        M, _ = A._perspective_matrix(dr["warp"], 2 * s, 2 * s, s // 2)
        warped[side] = [A.warp_image(A.mosaic4(
            b[k], b["labels4"], b["mask4"], dr["center"], s,
            pads=b["pads4"])[0], M, (s, s)) for k in ("rgb4", "ir4")]
    warp_err = max(float((g.cpu() - w).abs().max())
                   for g, w in zip(warped["card"], warped["cpu"]))

    def finish(rgb, ir, dr):
        return A._flip(A.augment_hsv(rgb, dr["gains_rgb"]),
                       A.augment_hsv(ir, dr["gains_ir"]), dr)
    want_hsv = finish(*warped["cpu"], draws)
    got_hsv = finish(*(w.to(dev) for w in warped["cpu"]),
                     _to(torch, draws, dev))
    hsv_err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got_hsv, want_hsv))
    return hsv_err, {"warp_max_abs_err": warp_err,
                     "end_to_end_max_abs_err": max(
                         float((g - w).abs().max())
                         for g, w in zip(got[:2], want[:2])),
                     "end_to_end_values_above_1e-4": sum(
                         int(((g - w).abs() > 1e-4).sum())
                         for g, w in zip(got[:2], want[:2]))}


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_mosaic_gate(torch, dev, card: str):
    """``make_batch_augment(640, hyp, 120, mosaic=True)``'s function on a
    batch of 8 from ``MosaicLoader`` (the eval path's square pairs), card
    against CPU with the same draws, on both of its paths: the default hyp
    (the axis-aligned path) and degrees 10, shear 2 (the canvas and the
    general warp); the card's ms a batch, its draws included, as the
    trainer calls it."""
    import dataclasses

    from mmidet_tpu_torch.data import augment as A
    from mmidet_tpu_torch.data.datasets import PairedDataset, load_data_yaml
    from mmidet_tpu_torch.data.loader import MosaicLoader
    t_phase = time.perf_counter()
    d = load_data_yaml(str(EVAL_DATA / "square" / "synthetic.yaml"))
    ds = PairedDataset(d["train_rgb"], d["train_ir"], nc=2,
                       cache_dir=str(EVAL_DATA / "mosaic_gate"))
    loader = MosaicLoader(ds, 8, 640, seed=0)
    t0 = time.perf_counter()
    raw = next(iter(loader))
    load_s = time.perf_counter() - t0
    cpu = {k: torch.from_numpy(raw[k]) for k in
           ("rgb4", "ir4", "labels4", "mask4", "pads4")}
    cpu["rgb4"] = cpu["rgb4"].float() / 255.0
    cpu["ir4"] = cpu["ir4"].float() / 255.0
    card_batch = _to(torch, cpu, dev)
    recs = []
    for branch, hyp in (("default", A.AugmentHyp()),
                        ("general", dataclasses.replace(
                            A.AugmentHyp(), degrees=10.0, shear=2.0))):
        draws = A.mosaic_draws(8, 640, hyp, torch.Generator().manual_seed(0))
        args = ("rgb4", "ir4", "labels4", "mask4")
        want = A.augment_pair_mosaic(*(cpu[k] for k in args), draws, 640,
                                     hyp, 120, pads4=cpu["pads4"])
        got = A.augment_pair_mosaic(*(card_batch[k] for k in args),
                                    _to(torch, draws, dev), 640, hyp, 120,
                                    pads4=card_batch["pads4"])
        got = [g.cpu() for g in got]
        lab_err = float((got[2] - want[2]).abs().max())
        masks_equal = bool(torch.equal(got[3], want[3]))
        gate = {}
        img_tol = MOSAIC_IMG_TOL
        if branch == "default":
            img_err = max(float((g - w).abs().max())
                          for g, w in zip(got[:2], want[:2]))
        else:
            img_err, gate = general_warp_gate(torch, A, cpu, card_batch,
                                              draws, got, want)
        fn = A.make_batch_augment(640, hyp, 120, mosaic=True)
        gen = torch.Generator(device=dev).manual_seed(1)
        ms = time_ms(lambda: fn(card_batch, gen), reps=10)
        t0 = time.perf_counter()
        fn(cpu, torch.Generator().manual_seed(1))
        cpu_s = time.perf_counter() - t0
        rec = {"phase": "mosaic_gate", "card": card, "branch": branch,
               "batch": 8, "img": 640, "loader_leg": "native"
               if loader.use_native else "pil", "loader_batch_s": load_s,
               "img_max_abs_err": img_err, "img_tol": img_tol,
               "label_max_abs_err": lab_err,
               "label_tol": MOSAIC_LABEL_TOL, "masks_equal": masks_equal,
               "valid_labels": int(want[3].sum()), **gate, "ms": ms,
               "host_cpu_s_same_call": cpu_s,
               "finite": all(bool(torch.isfinite(g).all())
                             for g in got[:3])}
        emit(rec)
        if img_err > img_tol or lab_err > MOSAIC_LABEL_TOL or \
                not masks_equal or not rec["finite"] or \
                not rec["valid_labels"] or \
                gate.get("warp_max_abs_err", 0.0) > MOSAIC_WARP_TOL:
            raise AssertionError(f"mosaic_gate: the card's mosaic "
                                 f"augmentation disagrees with the CPU's: "
                                 f"{rec}")
        recs.append(rec)
    emit({"phase": "mosaic_gate_done",
          "phase_seconds": time.perf_counter() - t_phase})
    return recs


def phase_train_flags_path(torch, dev, card: str):
    """One epoch each of ``quad``, ``multi_scale`` and ``rect`` through
    ``train`` (the flagship at 320 px, batch 8, bf16, on the eval path's
    first 16 pairs: square for the first two, 640x512 for rect: two steps
    and two evaluation batches an option), the shapes every step saw held
    against what the option gives, each evaluation's K1 and K2 calls held
    against their plain versions and their launches counted
    (``checked_eval``)."""
    from unittest import mock

    import yaml

    from mmidet_tpu_torch.data.datasets import PairedDataset
    from mmidet_tpu_torch.data.loader import RectLoader
    from mmidet_tpu_torch.train import trainer as trainer_mod
    t_phase = time.perf_counter()
    square_yaml, rect_yaml = evolve_data(16), evolve_data(16, "rect")
    with open(rect_yaml) as fh:
        rect_data = yaml.safe_load(fh)
    rgb, ir = rect_data["train_rgb"], rect_data["train_ir"]
    real_make, real_eval = trainer_mod.make_train_step, trainer_mod.evaluate
    recs = []
    for option, kw in (("quad", {"quad": True, "mosaic_prob": 1.0,
                                 "data": square_yaml}),
                       ("multi_scale", {"multi_scale": True,
                                        "mosaic_prob": 1.0,
                                        "data": square_yaml}),
                       ("rect", {"rect": True, "data": rect_yaml})):
        shapes, step_ms = [], []

        def make(*a, **k):
            inner = real_make(*a, **k)

            def step(state, batch):
                shapes.append(tuple(batch["rgb"].shape))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(state, batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return step

        evals = []
        counted = checked_eval(torch, f"train_flags_path {option}",
                               real_eval, evals)
        cfg = train_path_config(EVAL_DATA / f"flags_{option}", 1,
                                img_size=320, **kw)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(trainer_mod, "make_train_step", make), \
                mock.patch.object(trainer_mod, "evaluate", counted):
            out = trainer_mod.train(cfg, device=dev)
        secs = time.perf_counter() - t0
        after = read_counts()
        if any(after.values()):
            raise AssertionError(f"train_flags_path {option}: kernels "
                                 f"launched after the evaluation: {after}")
        if option == "quad":
            want = [(2, 640, 640, 3)] * len(shapes)
        elif option == "multi_scale":
            sizes = trainer_mod.multi_scale_sizes(320, 32, 0)
            ok = all(h == w and h in sizes for _, h, w, _ in shapes)
            want = shapes if ok else []
        else:
            ds = PairedDataset(rgb, ir, nc=2,
                               cache_dir=str(EVAL_DATA / "flags_rect"))
            rl = RectLoader(ds, 8, 320, stride=32, pad=0.0, scaleup=True)
            want = [(min(8, len(ds) - 8 * i), h, w, 3)
                    for i, (h, w) in enumerate(rl.shapes)]
        rec = {"phase": "train_flags_path", "card": card, "option": option,
               "model": "yolov5l_fuse3_fourier", "img": 320, "batch": 8,
               "dtype": "bfloat16", "step_shapes": sorted(set(shapes)),
               "steps": len(shapes), "micro_step_ms_median":
               statistics.median(step_ms), "peak_mem_gb":
               torch.cuda.max_memory_allocated() / 1e9,
               "losses": {k: out["epochs"][0][k] for k in
                          ("box", "obj", "cls", "aux")},
               "evals": evals, "seconds": secs}
        emit(rec)
        if shapes != want or not shapes or len(evals) != 1 or \
                not all(math.isfinite(v) for v in rec["losses"].values()):
            raise AssertionError(f"train_flags_path {option}: the steps "
                                 f"saw {shapes}, expected {want}: {rec}")
        if option == "multi_scale" and len(set(shapes)) < 2:
            raise AssertionError(f"train_flags_path: one size drawn {rec}")
        recs.append(rec)
    emit({"phase": "train_flags_path_done",
          "phase_seconds": time.perf_counter() - t_phase})
    return recs


# remat in f32 on the card: the same weights, batch and seed with remat
# "dots" and "full" against the step without; the recomputation runs the
# same kernels on the same inputs, so parameters and BN buffers agree to
# within 1e-5 of max(1, |value|) (cuDNN may pick another algorithm for a
# recomputed convolution); BN counts the batch once
REMAT_F32_TOL = 1e-5


def phase_remat(torch, dev, card: str):
    """One micro-step of the flagship at 640, batch 8, bf16 (accumulate 8:
    no optimizer step) with remat "", "dots" and "full": ms and peak
    memory each; then the f32 gate at 128 px, batch 2."""
    import copy

    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.models.zoo import get_model_spec
    from mmidet_tpu_torch.train.optimizer import build_optimizer
    from mmidet_tpu_torch.train.schedule import ScheduleConfig
    from mmidet_tpu_torch.train.step import init_state, make_train_step
    from mmidet_tpu_torch.train.trainer import anchors_grid
    t_phase = time.perf_counter()

    def batch(b, img, gen):
        targets = torch.zeros(b, 120, 5)
        targets[:, :3] = torch.tensor([[1, 0.5, 0.5, 0.3, 0.4],
                                       [0, 0.25, 0.3, 0.1, 0.15],
                                       [1, 0.7, 0.6, 0.2, 0.1]])
        return {"rgb": torch.rand(b, img, img, 3, generator=gen).to(dev),
                "ir": torch.rand(b, img, img, 3, generator=gen).to(dev),
                "targets": targets.to(dev),
                "mask": (torch.arange(120) < 3).expand(b, 120).to(dev)}

    def state_for(model, batch_size, nbs):
        sched = ScheduleConfig(epochs=2, steps_per_epoch=2, warmup_floor=1,
                               lr0=1e-3, warmup_bias_lr=1e-3)
        opt, _ = build_optimizer(model, sched, 0.0005,
                                 total_batch_size=batch_size, nbs=nbs)
        return init_state(model, opt)
    torch.manual_seed(0)
    spec = get_model_spec("yolov5l_fuse3_fourier", nc=2)
    model = TwoStreamDetector(spec, aux_mode="reference").to(dev)
    anchors = anchors_grid(spec).to(dev)
    b640 = batch(8, 640, torch.Generator().manual_seed(0))
    # a warm-up micro-step, then 3 timed ones a policy, each policy on a
    # state of its own (accumulate 8: no optimizer step; the gradients
    # stay allocated throughout)
    make_train_step(anchors, dtype="bfloat16")(state_for(model, 8, 64),
                                               b640)
    timed = []
    for remat in ("", "dots", "full"):
        step = make_train_step(anchors, dtype="bfloat16", remat=remat)
        state = state_for(model, 8, 64)
        ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, b640)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        timed.append({"remat": remat, "micro_step_ms": statistics.median(ms),
                      "micro_step_ms_all": ms, "peak_mem_gb":
                      torch.cuda.max_memory_allocated() / 1e9})
        if state.opt_step:
            raise AssertionError("remat: an optimizer step was taken")
    del state, model, b640
    torch.cuda.empty_cache()

    # f32 at 128 px, batch 2, TF32 off: with and without remat
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(1)
        base = TwoStreamDetector(spec, aux_mode="reference").to(dev)
        b128 = batch(2, 128, torch.Generator().manual_seed(1))
        out = {}
        for remat in ("", "dots", "full"):
            m = copy.deepcopy(base)
            st = state_for(m, 2, 2)
            torch.manual_seed(2)  # the dropout masks
            make_train_step(anchors, remat=remat)(st, b128)
            out[remat] = m.state_dict()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    errs, counts = {}, {}
    for remat in ("dots", "full"):
        errs[remat] = max(
            float((out[remat][k].float() - v.float()).abs().max())
            / max(1.0, float(v.float().abs().max()))
            for k, v in out[""].items() if v.is_floating_point())
        counts[remat] = sorted({int(v) for k, v in out[remat].items()
                                if k.endswith("num_batches_tracked")})
    rec = {"phase": "remat", "card": card, "model": "yolov5l_fuse3_fourier",
           "img": 640, "batch": 8, "dtype": "bfloat16", "runs": timed,
           "f32_128_max_rel_err": errs, "f32_tol": REMAT_F32_TOL,
           "bn_num_batches_tracked": counts,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if any(e > REMAT_F32_TOL for e in errs.values()) or \
            any(c != [1] for c in counts.values()) or \
            not all(math.isfinite(r["micro_step_ms"]) for r in timed):
        raise AssertionError(f"remat: {rec}")
    return rec


# ----------------------------------------------------------------------
# the trainer's remaining options, evolution, inference sources, the
# utils leftovers and the experimental aux modules
OPTIONS_BUCKET = "chip-smoke-bucket"


def gsutil_stub(where: Path):
    """A ``gsutil`` that records its arguments (one line a call) and
    succeeds, for the first place on ``PATH``: (its dir, its log)."""
    import stat
    where.mkdir(parents=True, exist_ok=True)
    log = where / "gsutil.log"
    exe = where / "gsutil"
    exe.write_text(f"#!{sys.executable}\nimport sys\n"
                   f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) "
                   f"+ '\\n')\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return where, log


@contextlib.contextmanager
def wandb_absent():
    """``import wandb`` fails inside (the W&B leg must not reach the
    network); ``sys.modules`` keeps every other module imported meanwhile
    (``mock.patch.dict`` would drop them, and a module imported again
    registers its torch library ops twice)."""
    missing = object()
    before = sys.modules.get("wandb", missing)
    sys.modules["wandb"] = None
    try:
        yield
    finally:
        if before is missing:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = before


def phase_train_options_path(torch, dev, card: str):
    """``train`` on the flagship at 320 px, batch 8, mosaic, 2 epochs on
    the eval path's first 16 square pairs (``evolve_data``: 2 steps an
    epoch, 2 batches an evaluation) with ``image_weights``,
    ``bbox_interval=1``, ``use_wandb`` (wandb held absent: the run goes
    on), ``log_artifacts`` and ``upload_dataset`` into a store under
    ``EVAL_DATA``, ``bucket`` through a recording ``gsutil`` stub and
    ``nosave`` (one checkpoint a run, the last epoch's); then the run
    resumed from ``wandb-artifact://`` for one more epoch.  Each
    evaluation checked and counted (``checked_eval``)."""
    import os
    from unittest import mock

    import numpy as np

    from mmidet_tpu_torch.data.loader import MosaicLoader
    from mmidet_tpu_torch.train import trainer as trainer_mod
    from mmidet_tpu_torch.utils import artifacts
    from mmidet_tpu_torch.utils.general import (labels_to_class_weights,
                                                labels_to_image_weights)
    t_phase = time.perf_counter()
    store = EVAL_DATA / "options_store"
    stub_dir, stub_log = gsutil_stub(EVAL_DATA / "options_bin")
    given, drawn, evals, results, waits, legs, loaders = ([] for _ in
                                                          range(7))

    class Loader(wait_timed(MosaicLoader, waits, legs)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append(self)

        def set_image_weights(self, weights):
            given.append(np.array(weights))
            super().set_image_weights(weights)

        def _indices(self, rng):
            drawn.append(super()._indices(rng))
            return drawn[-1]

    counted = checked_eval(torch, "train_options_path", trainer_mod.evaluate,
                           evals)

    def evaluate(*a, **kw):
        results.append(counted(*a, **kw))
        return results[-1]

    # nosave: a checkpoint only at a run's last epoch; the flagship's is
    # 2.5 GB, and all that a call writes to its machine's disk counts
    # against a 45 GiB limit, deleted files too
    options = dict(img_size=320, mosaic_prob=1.0, image_weights=True,
                   bbox_interval=1, use_wandb=True, log_artifacts=True,
                   bucket=OPTIONS_BUCKET, nosave=True, data=evolve_data())
    env = {"MMIDET_ARTIFACT_ROOT": str(store),
           "PATH": f"{stub_dir}{os.pathsep}{os.environ.get('PATH', '')}"}
    runs = []
    with mock.patch.dict(os.environ, env), \
            wandb_absent(), \
            mock.patch.object(trainer_mod, "evaluate", evaluate), \
            mock.patch.object(trainer_mod, "MosaicLoader", Loader):
        zero_counts()
        t0 = time.perf_counter()
        out = trainer_mod.train(train_path_config(
            EVAL_DATA / "options_run", 2, upload_dataset=True, **options),
            device=dev)
        runs.append(time.perf_counter() - t0)
        run_id = os.path.basename(out["workdir"])
        backend = artifacts.LocalBackend(root=str(store))
        art = backend.download(f"run_{run_id}_model:latest")
        meta = backend.metadata(f"run_{run_id}_model:latest")
        # an interrupted 3-epoch run leaves this artifact: the checkpoint
        # of epoch 1 with total_epochs 3 (v1 beside the run's own v0)
        artifacts.log_model_artifact(
            backend, run_id, os.path.join(art, "ckpt"), epoch=1,
            total_epochs=3, fitness=meta["fitness_score"],
            opt={**meta["opt"], "epochs": 3})
        t0 = time.perf_counter()
        resumed = trainer_mod.train(train_path_config(
            EVAL_DATA / "options_resumed", 2,
            resume=f"wandb-artifact://mmidet_tpu/{run_id}", **options),
            device=dev)
        runs.append(time.perf_counter() - t0)
    after = read_counts()
    if any(after.values()):
        raise AssertionError(f"train_options_path: kernels launched after "
                             f"the last evaluation: {after}")

    # the weights the trainer gave the loader after the first evaluation
    labels, nc = loaders[0].ds.labels, 2
    res = results[0]
    maps = np.full(nc, res.map)
    for i, name in enumerate(("box", "blob")):
        maps[i] = res.per_class.get(name, {}).get("ap", res.map)
    want_w = labels_to_image_weights(
        labels, nc, labels_to_class_weights(labels, nc) * (1 - maps) ** 2)
    n, seed = len(labels), train_path_config(EVAL_DATA).seed
    weights_ok = len(given) == 1 and np.array_equal(given[0], want_w)
    draw_ok = weights_ok and len(drawn) >= 2 and np.array_equal(
        drawn[1], np.random.default_rng(seed + 1).choice(
            n, n, p=given[0] / given[0].sum()))
    wd = Path(out["workdir"])
    media = {e: len(list((wd / "media" / f"epoch{e}").glob("*.jpg")))
             for e in (0, 1)}
    aliases = json.loads((store / "mmidet_tpu" / f"run_{run_id}_model" /
                          "aliases.json").read_text())
    datasets = sorted(p.name for p in (store / "mmidet_tpu").iterdir()
                      if not p.name.startswith("run_"))
    uploads = stub_log.read_text().splitlines()
    epochs = out["epochs"] + resumed["epochs"]
    seconds = [e["seconds"] for e in epochs]
    rec = {"phase": "train_options_path", "card": card,
           "model": "yolov5l_fuse3_fourier", "img": 320, "batch": 8,
           "dtype": "bfloat16", "mosaic": True, "loader_leg": legs,
           "wandb": "absent: the logger's W&B leg is None, the run went on",
           "epoch_seconds": seconds,
           "loader_wait_share": [w / s for w, s in zip(waits, seconds)],
           "run_seconds": runs, "maps_first_eval": maps.tolist(),
           "image_weights": given[0].tolist() if given else None,
           "image_weights_ok": weights_ok, "epoch1_draw_ok": draw_ok,
           "epoch1_distinct_images": len(set(drawn[1].tolist()))
           if len(drawn) > 1 else None,
           "media_jpgs": media, "model_aliases": aliases,
           "model_versions": sorted(p.name for p in (
               store / "mmidet_tpu" / f"run_{run_id}_model").glob("v*")),
           "model_artifact": meta, "dataset_artifacts": datasets,
           "gsutil_calls": uploads,
           "resumed_epochs": [e["epoch"] for e in resumed["epochs"]],
           "evals": evals, "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    results_txt = str(wd / "results.txt")
    if not (weights_ok and draw_ok and min(media.values()) > 0 and
            {"latest", "epoch 2"} <= set(aliases) and
            rec["model_versions"] == ["v0", "v1"] and
            meta["epochs_trained"] == 2 and
            datasets == ["train_ir", "train_rgb", "val_ir", "val_rgb"] and
            uploads[:2] == [f"cp {results_txt} gs://{OPTIONS_BUCKET}/"] * 2
            and rec["resumed_epochs"] == [2] and len(evals) == 3 and
            all(math.isfinite(e[k]) for e in epochs
                for k in ("box", "obj", "cls"))):
        raise AssertionError(f"train_options_path: {rec}")
    return rec


def evolve_data(n: int = 16, pairs: str = "square") -> str:
    """A dataset YAML of the eval set's first ``n`` pairs (hard links) of
    ``pairs`` ("square" or the 640x512 "rect" set), as train and val
    set."""
    import os

    import yaml
    src = EVAL_DATA / pairs
    dst = EVAL_DATA / (f"first{n}" if pairs == "square"
                       else f"{pairs}_first{n}")
    for mod in ("val_rgb", "val_ir"):
        imgs = sorted((src / mod / "images").glob("*.png"))[:n]
        for sub, files in (("images", imgs), ("labels", [
                src / mod / "labels" / (p.stem + ".txt") for p in imgs])):
            (dst / mod / sub).mkdir(parents=True, exist_ok=True)
            for f in files:
                if f.exists() and not (dst / mod / sub / f.name).exists():
                    os.link(f, dst / mod / sub / f.name)
    rgb, ir = (str(dst / m / "images") for m in ("val_rgb", "val_ir"))
    path = dst / "data.yaml"
    path.write_text(yaml.safe_dump({
        "train_rgb": rgb, "train_ir": ir, "val_rgb": rgb, "val_ir": ir,
        "nc": 2, "names": ["box", "blob"]}))
    return str(path)


def phase_evolve_path(torch, dev, card: str):
    """``cli.train.main(... --evolve 2 --epochs 1)`` on the flagship at
    320 px, batch 8, mosaic, on the first 16 pairs, ``--nbs 8`` (each of
    the 2 micro-steps an optimizer step, so that a generation's hyp moves
    its weights and its fitness), ``--nosave`` (one checkpoint a
    generation, see ``train_options_path``): two generations, each
    hyp what ``mutate`` gives for seed 0 and the history before it and
    within ``META``'s bounds, each generation's evaluation checked and
    counted (``checked_eval``)."""
    from unittest import mock

    import numpy as np

    from mmidet_tpu_torch.cli import train as train_cli
    from mmidet_tpu_torch.train import trainer as trainer_mod
    from mmidet_tpu_torch.train.evolve import META, mutate
    t_phase = time.perf_counter()
    data = evolve_data()
    evals, gen_seconds = [], []
    counted = checked_eval(torch, "evolve_path", trainer_mod.evaluate, evals)
    real_train = train_cli.train

    def timed_train(cfg, device):
        t0 = time.perf_counter()
        out = real_train(cfg, device=device)
        gen_seconds.append(time.perf_counter() - t0)
        return out
    project = EVAL_DATA / "evolve_runs"
    buf = io.StringIO()
    zero_counts()
    with mock.patch.object(trainer_mod, "evaluate", counted), \
            mock.patch.object(train_cli, "train", timed_train), \
            contextlib.redirect_stdout(buf):
        out = train_cli.main(
            ["--cfg", "yolov5l_fuse3_fourier", "--data", data, "--epochs",
             "1", "--batch-size", "8", "--img-size", "320", "--nbs", "8",
             "--nosave", "--project", str(project), "--name", "exp",
             "--evolve", "2"], device=dev)
    after = read_counts()
    rows = [json.loads(line) for line in
            (project / "exp_evolve" / "evolve.txt").read_text().splitlines()]
    rng, history, replay_ok, bounds_ok = np.random.default_rng(0), [], [], []
    base = trainer_mod.load_hyp("")
    for r in rows:
        replay_ok.append(r["hyp"] == mutate(base, history, rng))
        bounds_ok.append(all(lo <= r["hyp"][k] <= hi
                             for k, (_, lo, hi) in META.items()))
        history.append((r["fitness"], r["hyp"]))
    rec = {"phase": "evolve_path", "card": card,
           "model": "yolov5l_fuse3_fourier", "img": 320, "batch": 8,
           "pairs": 16, "generations": len(rows),
           "generation_seconds": gen_seconds,
           "fitness": [r["fitness"] for r in rows],
           "hyp_lr0": [r["hyp"]["lr0"] for r in rows],
           "replay_equal": replay_ok, "within_bounds": bounds_ok,
           "best_fitness": out["best_fitness"], "evals": evals,
           "stdout_tail": buf.getvalue().strip().splitlines()[-1:],
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if len(rows) != 2 or not all(replay_ok) or not all(bounds_ok) or \
            len(evals) != 2 or any(after.values()):
        raise AssertionError(f"evolve_path: {rec}, launches after the last "
                             f"evaluation {after}")
    return rec


SOURCE_FRAMES = 8               # frames a video, 640x512, MJPG
SOURCE_STILLS = 4               # JPEG pairs beside the videos
STREAM_FRAMES = 4               # LoadStreams iterations


def write_sources(root: Path) -> None:
    """An RGB and an IR dir, each with ``SOURCE_STILLS`` JPEGs and one
    MJPG ``clip.avi`` of ``SOURCE_FRAMES`` frames, all 640x512, from the
    eval path's 640x512 pairs."""
    import cv2
    import numpy as np
    from PIL import Image
    for mod in ("rgb", "ir"):
        (root / mod).mkdir(parents=True)
        frames = sorted((EVAL_DATA / "rect" / f"val_{mod}" /
                         "images").glob("*.png"))
        writer = cv2.VideoWriter(str(root / mod / "clip.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 10,
                                 (640, 512))
        if not writer.isOpened():
            raise RuntimeError("cv2 cannot write an MJPG .avi here")
        for f in frames[:SOURCE_FRAMES]:
            writer.write(np.asarray(Image.open(f).convert("RGB"))[:, :, ::-1])
        writer.release()
        for i, f in enumerate(frames[SOURCE_FRAMES:SOURCE_FRAMES +
                                     SOURCE_STILLS]):
            Image.open(f).convert("RGB").save(root / mod / f"p{i}.jpg",
                                              quality=95)


def phase_sources_path(torch, dev, card: str):
    """Inference sources through the flagship (``cli.val``'s deploy form,
    conditioned): two ``LoadImages`` in lockstep over stills and videos
    and a ``LoadStreams`` over the two videos, forward + NMS at batch 1
    (K3 1, K4 4, K2 1 a frame), every call checked; then timed; then
    ``feature_heatmap`` at ``l6`` and at a fusion row, kernel route
    against the plain versions; ``model_cost`` at 640 on both routes;
    ``bench_fn`` beside ``time_ms``; a ``trace`` of a forward."""
    import numpy as np

    from mmidet_tpu_torch.cli import val as val_cli
    from mmidet_tpu_torch.data.sources import LoadImages, LoadStreams
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    from mmidet_tpu_torch.tools.timing import time_ms
    from mmidet_tpu_torch.utils.gradcam import capture_names, feature_heatmap
    from mmidet_tpu_torch.utils.profiler import bench_fn, model_cost, trace
    t_phase = time.perf_counter()
    root = EVAL_DATA / "sources"
    write_sources(root)
    model, _ = val_cli.load_model_and_vars("yolov5l_fuse3_fourier", "", 2,
                                           device=dev)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).float() \
            / 255.0

    def pairs():
        return zip(LoadImages(str(root / "rgb"), 640),
                   LoadImages(str(root / "ir"), 640))
    stills = [(tensor(a[1][None]), tensor(b[1][None]))
              for a, b in list(pairs())[:SOURCE_STILLS]]
    condition(torch, model, torch.cat([s[0] for s in stills]),
              torch.cat([s[1] for s in stills]))

    def detect(rgb, ir):
        with torch.inference_mode():
            pred = model(rgb, ir)["pred"]
            return non_max_suppression(pred, 0.001, 0.6)

    # untimed: every call checked, on both sources
    checks, k2_paths, frames = [], [], {"images": 0, "streams": 0}
    zero_counts()
    with checked_kernels(torch, checks, k2_paths):
        for (pa, a, *_), (pb, b, *_) in pairs():
            if Path(pa).name != Path(pb).name:
                raise AssertionError(f"sources_path: {pa} beside {pb}")
            detect(tensor(a[None]), tensor(b[None]))
            frames["images"] += 1
        n_img = frames["images"]
        image_counts = read_counts(fused_cem=n_img, fused_gpt_merge=4 * n_img,
                                   nms_greedy=n_img)
        zero_counts()
        streams = LoadStreams([str(root / "rgb" / "clip.avi"),
                               str(root / "ir" / "clip.avi")], 640)
        try:
            for _, lbs, _, _ in streams:
                detect(tensor(lbs[:1]), tensor(lbs[1:]))
                frames["streams"] += 1
                if frames["streams"] == STREAM_FRAMES:
                    break
        finally:
            streams.close()
        stream_counts = read_counts(fused_cem=STREAM_FRAMES,
                                    fused_gpt_merge=4 * STREAM_FRAMES,
                                    nms_greedy=STREAM_FRAMES)
    checked = check_summary(checks)
    n_all = n_img + STREAM_FRAMES
    calls = {k: v["calls"] for k, v in checked.items()}
    # timed: decode, letterbox, copy, forward and NMS, as a user runs it
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for (_, a, *_), (_, b, *_) in pairs():
        dets, valid = detect(tensor(a[None]), tensor(b[None]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    timed_counts = read_counts(fused_cem=n_img, fused_gpt_merge=4 * n_img,
                               nms_greedy=n_img)

    # feature heatmaps: kernel route against the plain versions
    rgb, ir = stills[0]
    fusion_row = next(k for k in sorted(capture_names(model)) if "GPT" in k)
    heat = {}
    for layer in ("l6", fusion_row):
        zero_counts()
        got = feature_heatmap(model, rgb, ir, layer)
        counts = read_counts(fused_cem=1, fused_gpt_merge=4)
        with plain_versions(torch):
            want = feature_heatmap(model, rgb, ir, layer)
        heat[layer] = {"shape": list(got.shape), "launches": counts,
                       "max_abs_err": float(np.abs(got - want).max()),
                       "tol": K4_EVAL_TOL}
    # the model's cost at 640 on both routes, and its forward's time
    zero_counts()
    cost = model_cost(model, rgb, ir)
    cost_launches = read_counts(fused_cem=1, fused_gpt_merge=4)
    with plain_versions(torch):
        plain_cost = model_cost(model, rgb, ir)

    def forward():
        with torch.inference_mode():
            model(rgb, ir)
    bench_s = bench_fn(forward, iters=10)
    ev_ms = time_ms(forward, reps=10)
    trace_dir = EVAL_DATA / "sources_trace"
    with trace(str(trace_dir)):
        forward()
    names = {e.get("name", "") for e in json.loads(
        (trace_dir / "trace.json").read_text())["traceEvents"]}
    traced = {k: sorted(n for n in names if k in n)[:3]
              for k in ("cem_kernel", "merge_kernel")}
    rec = {"phase": "sources_path", "card": card,
           "model": "yolov5l_fuse3_fourier", "dtype": "bfloat16", "batch": 1,
           "img": 640, "frames": frames, "checked": checked,
           "k2_paths": {p: k2_paths.count(p) for p in sorted(set(k2_paths))},
           "launches_images": image_counts, "launches_streams": stream_counts,
           "launches_timed": timed_counts, "timed_frames": n_img,
           "timed_seconds": secs, "frames_per_s": n_img / secs,
           "last_frame_boxes": int(valid.sum()), "heatmaps": heat,
           "model_cost": cost, "model_cost_plain": plain_cost,
           "model_cost_launches": cost_launches,
           "bench_fn_ms": bench_s * 1e3, "time_ms": ev_ms,
           "trace_kernels": traced,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not all(v["ok"] for v in checked.values()) or calls != {
            "fused_cem": n_all, "fused_gpt_merge": 4 * n_all,
            "nms_greedy": n_all} or \
            n_img != SOURCE_STILLS + SOURCE_FRAMES or \
            any(h["max_abs_err"] > h["tol"] for h in heat.values()) or \
            cost["gflops"] != plain_cost["gflops"] or \
            cost["gflops"] <= 0 or not all(traced.values()):
        raise AssertionError(f"sources_path: {rec}")
    return rec


# the aux modules in f32 with TF32 off, card against CPU: convolutions and
# products sum in another order (cuDNN's algorithms), nothing compounds
# through more than five layers: 1e-5 of max |CPU value| (the losses: of
# their value)
AUX_TOL = 1e-5


def phase_aux_experimental_gate(torch, dev, card: str):
    """``nn/aux_experimental.py`` at 64 px in f32: the VAE (one noise
    tensor for both), both feature extractors in eval and train mode (the
    BN buffers after), the decoder and the losses, card against CPU."""
    import copy

    from mmidet_tpu_torch.nn import aux_experimental as aux
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 64, 64, generator=gen)
    feats = torch.randn(2, 8, 16, 16, generator=gen)
    eps = torch.randn(2, 16, generator=gen)
    torch.manual_seed(0)
    mods = {"vae": aux.VAE(3, 16, (64, 64)),
            "specific": aux.ModalitySpecificFeatureExtractor(3),
            "agnostic": aux.ModalityAgnosticFeatureExtractor(3),
            "decoder": aux.DecoderNetwork(8, 8)}

    def run(device):
        out = {}
        for name, m in mods.items():
            m = copy.deepcopy(m).to(device)
            if name == "vae":
                recon, mu, logvar = m.eval()(x.to(device), eps=eps.to(device))
                out.update(vae_recon=recon, vae_mu=mu, vae_logvar=logvar,
                           vae_loss=aux.vae_loss(recon, x.to(device), mu,
                                                 logvar))
            elif name == "decoder":
                out[name] = m(feats.to(device))
            else:
                out[f"{name}_eval"] = m.eval()(x.to(device))
                out[f"{name}_train"] = m.train()(x.to(device))
                out[f"{name}_running_var"] = m.BatchNorm_0.running_var
        a, p = out["specific_eval"].flatten(1), out["specific_train"].flatten(1)
        out["rec_contrastive_loss"] = aux.rec_contrastive_loss(a, p)
        out["reconstruction_loss"] = aux.reconstruction_loss(
            out["vae_recon"], x.to(device))
        return {k: v.detach().float().cpu() for k, v in out.items()}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want, got = run("cpu"), run(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    errs = {k: float((got[k] - w).abs().max()) /
            max(float(w.abs().max()), 1e-12) for k, w in want.items()}
    rec = {"phase": "aux_experimental_gate", "card": card, "img": 64,
           "dtype": "float32", "max_rel_err": errs, "tol": AUX_TOL,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    if any(not math.isfinite(e) or e > AUX_TOL for e in errs.values()):
        raise AssertionError(f"aux_experimental_gate: {rec}")
    return rec


DP_IMG = 320                    # dp_path: the flagship trains at 320 px,
DP_BATCH = 8                    # global batch 8 (accumulate 1),
DP_PAIRS = 8                    # 1 step an epoch, 1 epoch
DP_VAL_PAIRS = 7                # evaluate over [card, card] at batch 6:
DP_EVAL_BATCH = 6               # 6, then 1 padded to 2
DP_DATA = ROOT / "runs" / "chip_smoke_dp"  # git-ignored; removed after
# the mesh legs against the one-rank run (NCCL at world size 1): the same
# global batches, the same BatchNorm and loss sums, the same dropout
# masks, TF32 off on every rank, so the runs differ by the order of f32
# sums only (over the ranks, and cuDNN's per batch size).  In f64 on the
# CPU, one step of the flagship's grammar at "t" width over data 2 and
# over 2 x 2 moves every tensor as one process moves it, within 3e-13 of
# its change (tests/test_torch_port_mesh.py::
# test_f64_flagship_grammar_step_per_tensor).  In f32 here rounding
# spreads unevenly: one tensor, the IR stream's SPP input conv
# (model.27.cv1), differed by 4.7% of its change after 2 steps on an H100
# in every run of 2 steps, and data 2 and 2 x 2 by 3.0% from each other
# on it; the whole state by 2.4e-4 to 2.9e-4 (the path takes one step
# now, so rounding has one update less to spread).  So two gates: the
# whole state
# (|change of the run - change of the one rank| / |change of the one
# rank| over every float entry of the model, and of the EMA, together)
# within 1%, and each tensor's share within 10%.  A fault moves what it
# touches by its own change: a missing gradient average halves or doubles
# a tensor's change, 50% to 100%.
DP_MOVE_TOL = 1e-2
DP_TENSOR_TOL = 1e-1
DP_MOVE_FLOOR = 1e-6
# rank 0's loss metrics of every step against the one-rank run's: the
# step runs the same weights (4e-7 seen; a second step, after one update,
# read 4e-5)
DP_METRIC_RTOL = 1e-4
# evaluate and BatchingService over [card, card] are held against one
# device whose forwards take the shards' sizes (evaluate at batch 3,
# BatchingService at max_batch 4): records and metrics identical.  One
# device at the whole batch is not the reference: a bf16 forward of 3
# images rounds otherwise than one of 6 (cuDNN picks its algorithm by
# batch size), and at conf 0.001 records near a tie swap places or cross
# the 300 cut (seen: 6% of a served batch's records unmatched)


def dp_moves(torch, got: dict, want: dict, init: dict) -> dict:
    """``got`` against ``want`` by how far ``want`` moved from ``init``
    (see ``DP_MOVE_TOL``): over the whole state (``share``) and the worst
    tensor; integer entries equal."""
    worst = {"share": 0.0, "tensor_share": 0.0, "key": None}
    diff2 = move2 = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        w = w.cpu()
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"dp_path: {k} differs: {g} {w}")
            continue
        diff2 += float(((g - w).double() ** 2).sum())
        move2 += float(((w - init[k].cpu()).double() ** 2).sum())
        top = w.abs().max()
        ulp = 2 * float(torch.nextafter(top, top + 1) - top)
        moved = float((w - init[k].cpu()).abs().max())
        share = max(float((g - w).abs().max()) - ulp, 0.0) / max(
            moved, DP_MOVE_FLOOR)
        if share > worst["tensor_share"]:
            worst.update(tensor_share=share, key=k, moved=moved)
    worst["share"] = math.sqrt(diff2 / max(move2, 1e-30))
    return worst


def dp_train(torch, cfg, run, checked: bool):
    """``run(cfg)`` (a trainer entry point) with rank 0, in this process,
    recording its metrics of every step and its evaluations counted, and
    with ``checked`` held call by call against the plain versions
    (``checked_eval``); rank 0's checkpoint (whole tensors, 2.5 GB) is
    counted, not written: a call's disk writes are capped.  Returns
    (result, metrics, evals, seconds)."""
    from unittest import mock

    from mmidet_tpu_torch.train import trainer as trainer_mod
    metrics, evals = [], []
    real_make = trainer_mod.make_train_step

    def make(*a, **kw):
        inner = real_make(*a, **kw)

        def step(state, batch, group=None):
            out = inner(state, batch, group)
            metrics.append({k: float(v) for k, v in out.items()})
            return out
        return step
    real_eval = trainer_mod.evaluate

    def counted(model, loader, nc, **kw):
        if any(read_counts().values()):
            raise AssertionError("dp_path: the train steps launched kernels")
        res = real_eval(model, loader, nc, **kw)
        nb = len(loader)
        evals.append({"batches": nb, "launches": read_counts(
            fused_token_transformer=4 * nb, nms_greedy=nb,
            nms_greedy_large=nb)})
        zero_counts()
        return res
    saves = []

    def save(ckpt_dir, state, epoch, meta=None, keep=3):
        saves.append({"epoch": epoch, "entries": len(
            state.model.state_dict()) + len(state.ema.state_dict())})
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(trainer_mod, "make_train_step", make), \
            mock.patch.object(trainer_mod, "save_checkpoint", save), \
            mock.patch.object(trainer_mod, "evaluate", checked_eval(
                torch, "dp_path", real_eval, evals) if checked else counted):
        out = run(cfg)
    if len(saves) != 1:
        raise AssertionError(f"dp_path: rank 0 saved {saves}")
    return out, metrics, evals, time.perf_counter() - t0


def eval_records(path: str) -> list:
    """An evaluation's COCO records by image, as ``record_gap`` reads
    them."""
    with open(path) as fh:
        recs = json.load(fh)
    by_image = {}
    for r in recs:
        x, y, w, h = r["bbox"]
        by_image.setdefault(r["image_id"], []).append(
            {"class": r["category_id"], "xmin": x, "ymin": y,
             "xmax": x + w, "ymax": y + h, "confidence": r["score"]})
    return [by_image[k] for k in sorted(by_image)]


def phase_dp_path(torch, dev, card: str):
    """Data and tensor parallelism on the card (see the module docstring,
    step 26): (a) ``train`` of the flagship over ``[dev] * 2`` (gloo, data
    2) and ``[dev] * 4`` (data 2 x model 2, ``tp_min_out`` 256), (b) the
    same steps on a one-rank NCCL mesh, the reference of the others, (c)
    NCCL over two cards where there are two, (d) ``evaluate`` over two
    entries of ``dev`` on a ragged set, flagship (K3 + K4 + K2) and
    yolov5s_gpt4 (K3 + K1 + K2), (e) ``BatchingService`` over two entries.
    Returns the record."""
    import dataclasses
    import shutil
    import threading

    from mmidet_tpu_torch.cli import val as val_cli
    from mmidet_tpu_torch.data.datasets import PairedDataset, load_data_yaml
    from mmidet_tpu_torch.data.loader import PairedLoader
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.deploy.serve import BatchingService
    from mmidet_tpu_torch.eval.evaluator import evaluate
    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    from mmidet_tpu_torch.models.zoo import get_model_spec
    from mmidet_tpu_torch.parallel.mesh import tp_modules
    from mmidet_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    shutil.rmtree(DP_DATA, ignore_errors=True)
    make_synthetic_pair_dataset(str(DP_DATA / "data"), n=DP_PAIRS,
                                img=DP_IMG)
    # rank 0's evaluation: one batch
    data = make_synthetic_pair_dataset(str(DP_DATA / "data"),
                                       n=DP_VAL_PAIRS, img=DP_IMG, seed=1,
                                       split="val")
    # the trainer's own seeded init (trainer.py: seed 0, CPU RNG)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        first = TwoStreamDetector(get_model_spec("yolov5l_fuse3_fourier",
                                                 nc=2), aux_mode="reference")
    init = {k: v.clone() for k, v in first.state_dict().items()}
    tp_layers = len(tp_modules(first, 2, 256))
    del first
    base = trainer_mod.TrainConfig(
        model="yolov5l_fuse3_fourier", data=data,
        hyp={"lr0": 1e-3, "warmup_bias_lr": 1e-3}, epochs=1,
        batch_size=DP_BATCH, img_size=DP_IMG, mosaic_prob=0.0,
        aux_mode="reference", use_cem=True, dtype="float32", seed=0,
        exist_ok=True, autoanchor=False, notest=True, nosave=True,
        nbs=DP_BATCH, warmup_floor=1)
    d0 = str(dev)
    legs = [("nccl_world1", {}, lambda c: trainer_mod.train_mesh(
                c, [d0], 1, 1)),
            ("gloo_data2", {}, lambda c: trainer_mod.train(
                c, devices=[d0] * 2)),
            ("gloo_data2_model2", {"n_model": 2},
             lambda c: trainer_mod.train(c, devices=[d0] * 4))]
    if torch.cuda.device_count() > 1:
        legs.append(("nccl_data2_cards", {}, lambda c: trainer_mod.train(
            c, devices=["cuda:0", "cuda:1"])))
    else:
        print(json.dumps({"nccl_multi_card": "not run: 1 card"}),
              flush=True)
    want_mesh = {"nccl_world1": (1, 1, "nccl"), "gloo_data2": (2, 1, "gloo"),
                 "gloo_data2_model2": (2, 2, "gloo"),
                 "nccl_data2_cards": (2, 1, "nccl")}
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # every rank in true f32
    train_recs, ref = {}, None
    try:
        for name, kw, run in legs:
            cfg = dataclasses.replace(base, workdir=str(DP_DATA / name),
                                      **kw)
            out, metrics, evals, secs = dp_train(torch, cfg, run,
                                                 checked=ref is None)
            st = out["state"]
            rec = {"seconds": secs, "mesh": out["mesh"], "steps": len(metrics),
                   "loop_seconds": out["epochs"][0]["seconds"],
                   "metrics": metrics, "evals": evals}
            if ref is None:
                ref = (st.model.state_dict(), st.ema.state_dict(), metrics)
            else:
                rec["metric_rel_gap"] = [max(
                    abs(m[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r)
                    for m, r in zip(metrics, ref[2])]
                rec["model_vs_world1"] = dp_moves(
                    torch, st.model.state_dict(), ref[0], init)
                rec["ema_vs_world1"] = dp_moves(
                    torch, st.ema.state_dict(), ref[1], init)
            train_recs[name] = rec
            if name == "gloo_data2":
                d2_state = (st.model.state_dict(), st.ema.state_dict())
            elif name == "gloo_data2_model2":
                rec["model_vs_data2"] = dp_moves(
                    torch, st.model.state_dict(), d2_state[0], init)
            print(json.dumps({"dp_path_leg": name, "seconds": secs,
                              "loop_seconds": rec["loop_seconds"],
                              **{k: rec[k] for k in rec if k.endswith(
                                  ("_gap", "_world1", "_data2"))}}),
                  flush=True)
            m = out["mesh"]
            ok = ((m["data"], m["model"], m["backend"]) == want_mesh[name]
                  and len(metrics) == DP_PAIRS // DP_BATCH
                  and len(evals) == 1
                  and max(rec.get("metric_rel_gap", [0.0])) <= DP_METRIC_RTOL
                  and all(rec.get(k, {"share": 0.0})["share"] <= DP_MOVE_TOL
                          for k in ("model_vs_world1", "ema_vs_world1"))
                  and all(rec.get(k, {"tensor_share": 0.0})["tensor_share"]
                          <= DP_TENSOR_TOL
                          for k in ("model_vs_world1", "ema_vs_world1")))
            if not ok:
                raise AssertionError(f"dp_path {name}: {rec}")
            del out, st
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32

    # (d) evaluate over two entries of the card, a ragged set; one device
    # at half the batch meets the same shards (3, 3; 1, the pad dropped)
    d = load_data_yaml(data)
    ds = PairedDataset(d["val_rgb"], d["val_ir"], nc=2,
                       cache_dir=str(DP_DATA))
    sets = {how: (devs, list(PairedLoader(ds, bs, DP_IMG, drop_last=False,
                                          prefetch=0)))
            for how, devs, bs in (("one", [dev], DP_EVAL_BATCH // 2),
                                  ("two", [dev, dev], DP_EVAL_BATCH))}
    eval_recs = {}
    for name, per_forward in (
            ("yolov5l_fuse3_fourier", {"fused_cem": 1, "fused_gpt_merge": 4}),
            ("yolov5s_gpt4", {"fused_token_transformer": 4,
                              "fused_cem": 1})):
        model, _ = val_cli.load_model_and_vars(name, "", 2, device=dev)
        condition(torch, model, *(torch.from_numpy(
            sets["one"][1][0][k]).to(dev).float() / 255.0
            for k in ("rgb", "ir")))
        runs = {}
        for how, (devs, batches) in sets.items():
            path = str(DP_DATA / f"{name}_{how}.json")
            nb = len(batches)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = evaluate(model, batches, 2, device=dev, devices=devs,
                           save_json=path)
            secs = time.perf_counter() - t0
            launches = read_counts(   # a forward a device entry a batch
                **{k: v * nb * len(devs) for k, v in per_forward.items()},
                nms_greedy=nb, nms_greedy_large=nb)
            runs[how] = {"seconds": secs, "batches": nb, "launches": launches,
                         "metrics": [res.mp, res.mr, res.map50, res.map],
                         "records": eval_records(path)}
        checks, paths = [], []
        with checked_kernels(torch, checks, paths):
            evaluate(model, sets["two"][1], 2, device=dev,
                     devices=[dev, dev])
        checked = check_summary(checks)
        nb = runs["two"]["batches"]
        eval_recs[name] = {
            "checked": checked,
            "records": [len(r) for r in runs["one"]["records"]],
            "identical": all(runs["one"][k] == runs["two"][k]
                             for k in ("records", "metrics")),
            **{f"{k}_{how}": runs[how][k] for how in runs
               for k in ("seconds", "batches", "launches", "metrics")}}
        calls = {k: v["calls"] for k, v in checked.items()}
        if not all(v["ok"] for v in checked.values()) or calls != {
                **{k: 2 * v * nb for k, v in per_forward.items()},
                "nms_greedy": nb} or not sum(eval_recs[name]["records"]) \
                or not eval_recs[name]["identical"]:
            raise AssertionError(f"dp_path evaluate {name}: "
                                 f"{eval_recs[name]}")
        if name == "yolov5l_fuse3_fourier":
            flagship = model
        else:
            del model

    # (e) BatchingService over two entries of the card, against one device
    # at half the batch (the shards' size)
    pairs, _ = serve_pairs()
    pairs = pairs[:DP_BATCH]
    answers, serve_rec = {}, {}
    for how, devs, max_batch in (("one", None, DP_BATCH // 2),
                                 ("two", [dev, dev], DP_BATCH)):
        svc = BatchingService(flagship, [str(i) for i in range(2)],
                              img_size=DP_IMG, conf_thres=SERVE_CONF,
                              max_batch=max_batch, max_wait_ms=200.0,
                              device=dev, devices=devs)
        got = [None] * len(pairs)
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, svc.predict(*pairs[i]))) for i in range(len(pairs))]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fw = len(svc.batch_log) * (1 if devs is None else len(devs))
        serve_rec[how] = {"seconds": time.perf_counter() - t0,
                          "batches": len(svc.batch_log),
                          "launches": read_counts(
                              fused_cem=fw, fused_gpt_merge=4 * fw,
                              nms_greedy=len(svc.batch_log))}
        svc.close()
        if any(a is None for a in got):
            raise AssertionError(f"dp_path serve {how}: a request failed")
        answers[how] = got
    serve_rec.update(records=[len(r) for r in answers["one"]],
                     identical=answers["one"] == answers["two"])
    if not sum(serve_rec["records"]) or not serve_rec["identical"]:
        raise AssertionError(f"dp_path serve: {serve_rec}")
    del flagship
    torch.cuda.empty_cache()
    shutil.rmtree(DP_DATA, ignore_errors=True)
    rec = {"phase": "dp_path", "card": card, "model": "yolov5l_fuse3_fourier",
           "img": DP_IMG, "batch": DP_BATCH, "dtype": "float32",
           "tp_layers_at_256": tp_layers, "train": train_recs,
           "nccl_multi_card": ("run" if torch.cuda.device_count() > 1
                               else "not run: 1 card"),
           "evaluate": eval_recs, "serve": serve_rec,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def summed(recs, key):
    return sum(r[key] for r in recs)


def majority_bound(recs):
    ops = sum(r["bound_by"] == "operations" for r in recs)
    return "operations" if 2 * ops > len(recs) else "bytes"


def main() -> int:
    import shutil
    import threading

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from mmidet_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    # the plain versions and the f32 comparisons run in true f32
    torch.backends.cuda.matmul.allow_tf32 = False

    # eval_path's data is written while nvcc builds, and is complete
    # before the first timed phase
    data = {}
    writer = threading.Thread(
        target=lambda: data.update(seconds=write_eval_data()), daemon=True)
    writer.start()
    secs = kernels.build_all()
    regs = [ln.strip() for n in kernels.LIBRARIES
            for ln in kernels.build_log(n).splitlines() if "Used" in ln]
    t0 = time.perf_counter()
    writer.join()
    if "seconds" not in data:
        raise RuntimeError("writing eval_path's data failed")
    emit({"phase": "build", "seconds": secs,
          "libraries": list(kernels.LIBRARIES), "ptxas": regs,
          "eval_data_seconds": data["seconds"],
          "eval_data_wait_seconds": time.perf_counter() - t0})

    phase_layer_gemm(torch, dev, card)
    k1 = phase_k1(torch, dev)
    k2 = phase_k2(torch, dev)
    k3 = phase_k3(torch, dev)
    k4 = phase_k4(torch, dev)
    k2_large = phase_k2(torch, dev, K=30000)
    first, _ = phase_path(
        torch, dev, name, "main_path", "main_path_vs_plain", "yolov5s_gpt4",
        {"kernel_fusion": True},
        {"fused_token_transformer": 4, "nms_greedy": 1}, reps=5)
    flagship, pred = phase_path(
        torch, dev, name, "flagship_path", "flagship_vs_plain",
        "yolov5l_fuse3_fourier",
        {"kernel_cem": True, "kernel_merge": True},
        {"fused_cem": 1, "fused_gpt_merge": 4, "nms_greedy": 1},
        alt_flags={"kernel_fusion": True})
    eval_nms = phase_eval_nms(torch, pred)
    del pred
    phase_eval_path(torch, dev, name, data["seconds"])
    train = phase_train_path(torch, dev, name)
    phase_train_f32_gate(torch, dev, name)
    phase_mosaic_gate(torch, dev, name)
    train_mosaic = phase_train_path(torch, dev, name, "train_mosaic_path",
                                    epochs=1, mosaic_prob=1.0)
    train_flags = phase_train_flags_path(torch, dev, name)
    phase_remat(torch, dev, name)
    options = phase_train_options_path(torch, dev, name)
    evolved = phase_evolve_path(torch, dev, name)
    sources = phase_sources_path(torch, dev, name)
    phase_aux_experimental_gate(torch, dev, name)
    dp = phase_dp_path(torch, dev, name)
    shutil.rmtree(EVAL_DATA, ignore_errors=True)
    model, pairs, payloads, serving = phase_serve_path(torch, dev, name)
    int8 = phase_int8_path(torch, dev, name, model, pairs, payloads)
    del model
    torch.cuda.empty_cache()
    hub_rec = phase_hub_path(torch, dev, name)
    s8 = phase_s8_gate_path(torch, dev, name)
    resumed = phase_resume_path(torch, dev, name)
    exported = phase_export_path(torch, dev, name)
    exported_rows = phase_export_rows_path(torch, dev, name)
    mamba, _ = phase_path(
        torch, dev, name, "mamba_path", "mamba_vs_plain", "yolov5x_mamba",
        {"kernel_fusion": False}, {"nms_greedy": 1}, reps=5,
        extra=lambda m, rgb, ir: mamba_levels(torch, m, rgb, ir))
    phase_train_f32_gate(torch, dev, name, "yolov5s_mamba",
                         "mamba_train_gate")
    yaml_recs = phase_yaml_path(torch, dev, name)
    p1, p1_launches = phase_p1(torch, dev)
    p2, p3, probe_launches = phase_p2_p3(torch, dev)

    # K1's row sums the four levels of the yolov5s_gpt4 forward
    k1_path = [r for r in k1 if r["d"] <= 512]
    shape_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "max_abs_err")
    summary = {"kernels": [
        {"name": "fused_token_transformer", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/token_transformer.cu",
         "replaces": "mmidet_tpu/nn/transformer_pallas.py:218",
         "launches": first["fused_token_transformer"],
         # the trainer's per-epoch evaluation: 4 a batch, every epoch
         "train_eval_launches": sum(e["launches"]["fused_token_transformer"]
                                    for e in train["evals"]),
         "train_mosaic_eval_launches": sum(
             e["launches"]["fused_token_transformer"]
             for e in train_mosaic["evals"]),
         "train_flags_eval_launches": sum(
             e["launches"]["fused_token_transformer"]
             for r in train_flags for e in r["evals"]),
         # the evaluations of train_options_path (3) and evolve_path (2)
         "train_options_eval_launches": sum(
             e["launches"]["fused_token_transformer"]
             for e in options["evals"]),
         "evolve_eval_launches": sum(
             e["launches"]["fused_token_transformer"]
             for e in evolved["evals"]),
         # hub.yolov5s_gpt4 on 4 images: 4 a forward, 3 forwards with TTA
         "hub_launches": {k: r["launches"]["fused_token_transformer"]
                          for k, r in hub_rec["runs"].items()},
         # the exported yolov5s_gpt4 program, loaded back: 4 a call
         "export_launches": exported["gpt4"]["launches"][
             "fused_token_transformer"],
         # dp_path: rank 0's evaluation of each train leg, and yolov5s_gpt4
         # evaluated over two entries of the card (4 a shard)
         "dp_train_eval_launches": {
             k: sum(e["launches"]["fused_token_transformer"]
                    for e in r["evals"]) for k, r in dp["train"].items()},
         "dp_eval_launches": dp["evaluate"]["yolov5s_gpt4"][
             "launches_two"]["fused_token_transformer"],
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
         # one a served batch (timed serve_path runs), one a quantized
         # batch, one a hub call
         "serve_launches": serving["launches"]["nms_greedy"],
         "int8_launches": int8["launches"]["nms_greedy"],
         "hub_launches": {k: r["launches"]["nms_greedy"]
                          for k, r in hub_rec["runs"].items()},
         # one a batch of yolov5x_mamba and of each YAML model
         "mamba_launches": mamba["nms_greedy"],
         "yaml_launches": {r["model"]: r["launches_per_forward"]["nms_greedy"]
                           for r in yaml_recs},
         # one a frame of sources_path's timed LoadImages pass
         "sources_launches": sources["launches_timed"]["nms_greedy"],
         # dp_path: one a batch of BatchingService over two entries
         "dp_serve_launches": dp["serve"]["two"]["launches"]["nms_greedy"],
         # s8_gate_path: one a batch of the float and of the int8
         # evaluation, and the trainer's final evaluation; resume_path:
         # the evaluation of the first run and of the resumed one
         "s8_gate_launches": s8["launches"]["nms_greedy"],
         "s8_train_eval_launches": s8["train_launches"]["nms_greedy"],
         "resume_launches": {
             "first": resumed["launches_first"]["nms_greedy"],
             "resumed": resumed["launches"]["nms_greedy"]},
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "fused_cem", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/cem.cu",
         "replaces": "mmidet_tpu/nn/cem_pallas.py:280",
         "launches": flagship["fused_cem"],
         "serve_launches": serving["launches"]["fused_cem"],
         "int8_launches": int8["launches"]["fused_cem"],
         "hub_launches": {k: r["launches"]["fused_cem"]
                          for k, r in hub_rec["runs"].items()},
         # the exported flagship program, loaded back: 1 a call
         "export_launches": exported["flagship"]["launches"]["fused_cem"],
         # the f32 forward the SavedModel and TFLite files are held against
         "tf_export_gate_launches": exported["tf"]["launches"]["fused_cem"],
         # the same for yolov5x_mamba's files (export_rows_path)
         "tf_rows_gate_launches": exported_rows["launches"],
         "sources_launches": sources["launches_timed"]["fused_cem"],
         # dp_path: one a shard, evaluate (both models) and
         # BatchingService over two entries of the card
         "dp_eval_launches": sum(r["launches_two"]["fused_cem"]
                                 for r in dp["evaluate"].values()),
         "dp_serve_launches": dp["serve"]["two"]["launches"]["fused_cem"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]},
        # K4's row sums the four levels of the flagship forward
        {"name": "fused_gpt_merge", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/gpt_merge.cu",
         "replaces": "mmidet_tpu/nn/fusion_pallas.py:298",
         "launches": flagship["fused_gpt_merge"],
         "serve_launches": serving["launches"]["fused_gpt_merge"],
         "int8_launches": int8["launches"]["fused_gpt_merge"],
         # the exported flagship program, loaded back: 4 a call
         "export_launches": exported["flagship"]["launches"][
             "fused_gpt_merge"],
         "tf_export_gate_launches": exported["tf"]["launches"][
             "fused_gpt_merge"],
         "sources_launches": sources["launches_timed"]["fused_gpt_merge"],
         "dp_eval_launches": dp["evaluate"]["yolov5l_fuse3_fourier"][
             "launches_two"]["fused_gpt_merge"],
         "dp_serve_launches": dp["serve"]["two"]["launches"][
             "fused_gpt_merge"],
         "max_abs_err": max(r["max_abs_err"] for r in k4),
         "ms": summed(k4, "ms"), "plain_ms": summed(k4, "plain_ms"),
         "bound_ms": summed(k4, "bound_ms"),
         "bound_by": majority_bound(k4),
         "library_ms": summed(k4, "library_ms"),
         "per_shape": [{k: r[k] for k in ("d", "hw", "gated") + shape_keys}
                       for r in k4]},
        # K2 at pools above 4096: its cluster form, on the evaluator's path
        {"name": "nms_greedy_large", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/nms_greedy.cu",
         "replaces": "mmidet_tpu/ops/nms_pallas.py:82",
         "launches": eval_nms["nms_greedy_large"],
         "train_eval_launches": sum(e["launches"]["nms_greedy_large"]
                                    for e in train["evals"]),
         "train_mosaic_eval_launches": sum(
             e["launches"]["nms_greedy_large"]
             for e in train_mosaic["evals"]),
         "train_flags_eval_launches": sum(
             e["launches"]["nms_greedy_large"]
             for r in train_flags for e in r["evals"]),
         "train_options_eval_launches": sum(
             e["launches"]["nms_greedy_large"] for e in options["evals"]),
         "evolve_eval_launches": sum(
             e["launches"]["nms_greedy_large"] for e in evolved["evals"]),
         # dp_path: rank 0's evaluations, and both models evaluated over
         # two entries of the card
         "dp_train_eval_launches": {
             k: sum(e["launches"]["nms_greedy_large"] for e in r["evals"])
             for k, r in dp["train"].items()},
         "dp_eval_launches": sum(
             r["launches_two"]["nms_greedy_large"]
             for r in dp["evaluate"].values()),
         # s8_gate_path's float and int8 evaluations (1 a batch)
         "s8_gate_launches": s8["launches"]["nms_greedy_large"],
         "max_abs_err": k2_large["max_abs_err"], "ms": k2_large["ms"],
         "plain_ms": k2_large["plain_ms"], "bound_ms": k2_large["bound_ms"],
         "bound_by": k2_large["bound_by"], "library_ms": None},
        # P1's row is the probe's own shape (128 x 160 x 160 x 64)
        {"name": "conv_chain", "route": "cuda",
         "source": "mmidet_tpu_torch/csrc/conv_chain.cu",
         "replaces": "tools/_probe_igemm.py:97",
         "launches": p1_launches["conv_chain"],
         **{k: p1[0][k] for k in shape_keys},
         "device_ms": p1[0]["device_ms"], "launch": p1[0]["launch"],
         "ptxas": p1[0]["ptxas"],
         "per_shape": [{k: r[k] for k in ("batch", "hw", "c") + shape_keys}
                       for r in p1]},
        # P2's and P3's rows sum their bodies; each body beside the launch
        # floor timed in turns with it, and the row the floor's range over
        # the probe's run
        *({"name": name, "route": "cuda",
           "source": "mmidet_tpu_torch/csrc/cem_probes.cu",
           "replaces": site, "launches": probe_launches[name],
           "max_abs_err": max(r["max_abs_err"] for r in recs),
           **{k: summed(recs, k) for k in (
               "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
               "library_device_ms")},
           "bound_by": majority_bound(recs),
           **{f"{k}_range": [min(x for r in recs for x in r[f"{k}_turns"]),
                             max(x for r in recs for x in r[f"{k}_turns"])]
              for k in ("floor_ms", "floor_device_ms")},
           "per_body": [{k: r[k] for k in ("body",) + shape_keys + (
               "device_ms", "library_device_ms", "library_max_abs_err",
               "floor_ms", "floor_device_ms", "floor_ms_turns",
               "floor_device_ms_turns")} for r in recs]}
          for name, site, recs in (
              ("halo_sum", "tools/_probe_cem_r3.py:39", p2),
              ("lane_matmul", "tools/_probe_cem_fb.py:33", p3)))]}
    emit(summary)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
