#!/usr/bin/env python3
"""Where the port's main paths spend their time on one NVIDIA card.

    python3 chip_profile.py

Builds the same seeded deploy models as ``chip_smoke.py`` (BN folded, bf16,
batch 16 at 640x640) and prints JSON lines:
  * ``memory_format``: yolov5s_gpt4's forward time in NCHW and in
    channels_last memory format, timed in turns (nchw, cl, cl, nchw) with
    CUDA events;
  * ``breakdown``, once per model and kernel route: one forward + NMS under
    ``torch.profiler``: device time by kernel group (the hand-written
    kernels, convolutions, PyTorch's pooling and resampling, the rest),
    the host wall time of the window and the device's idle share of it;
    the rest also by the PyTorch operator that launched it.  yolov5s_gpt4
    runs K1 and K2; yolov5l_fuse3_fourier runs K3, K4 and K2, and once more
    with K1, the cuDNN CEM and the unfused pooling and upsampling.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the layer kernels of csrc/token_transformer.cuh run inside K1 or inside K4,
# whichever the route launches
_LAYERS = ("layernorm_kernel", "gemm_kernel", "attention_kernel")
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

    by_group: dict[str, float] = {}
    launches: dict[str, int] = {}
    top: dict[str, tuple] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        dev_us = evt.self_device_time_total
        g = group(evt.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3
        launches[g] = launches.get(g, 0) + evt.count
        top[evt.key[:80]] = (dev_us / 1e3, evt.count)
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
        "top_kernels_ms_and_launches": dict(
            sorted(top.items(), key=lambda kv: -kv[1][0])[:14]),
        "other_by_operator_ms_and_launches": dict(
            sorted(other_by_op.items(), key=lambda kv: -kv[1][0])[:14])
        or "not measured",
        "matrix_kernels_of_convolutions_ms": sum(
            k.duration for e in cpu_ops if e.name == "aten::cudnn_convolution"
            for k in e.kernels if "nvjet" in k.name.lower()) / 1e3}),
          flush=True)


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
